"""End-to-end example on the PyTorch port: train a ~100M-param LM for a few
hundred steps with the paper's runtime features live — WCRDT metric windows
(deterministic global aggregation without barriers), decentralized
checkpoints, crash recovery.

Quick demo (tiny model; crashes after step 25 and restores from step 20):
    PYTHONPATH=src python examples/torch/train_lm.py [--device cpu]
Full run (100M params, 300 steps at batch 8 x seq 512):
    PYTHONPATH=src python examples/torch/train_lm.py --full
"""
import argparse
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="100M-param preset instead of the tiny demo")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main

    with tempfile.TemporaryDirectory(prefix="repro_torch_example_ckpt") as tmp:
        common = ["--device", args.device, "--ckpt-dir", args.ckpt_dir or tmp]
        return train_main(
            ["--preset", "100m", "--steps", "300", "--batch", "8", "--seq", "512", *common]
            if args.full
            else ["--preset", "tiny", "--steps", "40", "--crash-at", "25",
                  "--ckpt-every", "10", *common]
        )


if __name__ == "__main__":
    main()
