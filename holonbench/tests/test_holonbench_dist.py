"""The four-card cell's path on the CPU (the cell as a later change adds it
to BENCHMARK.json, ``conftest.FOUR_CARD``): four gloo ranks of four owner
shards each run the harness as its ranks do on the cards, and rank 0's
result holds every window bitwise against the plain reference; with the
exchange between the ranks left out it does not, nor does the control.
"""
from _dist import run_ranks


def test_keyed_four_ranks_correct(tiny, four_card_root):
    res = run_ranks(four_card_root, "keyed-q5-1m-4x", tiny["keyed-q5-1m-4x"], world=4, seed=2**31 + 11)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    assert res["attempted"] > 0 and res["failed"] == 0


def test_keyed_four_ranks_traced_reads_the_wire(tiny, four_card_root):
    res = run_ranks(four_card_root, "keyed-q5-1m-4x", tiny["keyed-q5-1m-4x"], world=4, seed=5, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # a rank's exchange buffer: 4 owner rows x 16 destinations x B lanes x 13 bytes
    B = tiny["keyed-q5-1m-4x"]["events_per_batch"]
    assert m["wire_bytes_per_step"]["value"] >= 4 * 16 * B * 13
    assert m["exchange_ms_per_step"]["value"] > 0
    assert "device_idle_share" not in m  # no device events on the host


def test_keyed_four_ranks_exchange_left_out(tiny, four_card_root):
    res = run_ranks(four_card_root, "keyed-q5-1m-4x", tiny["keyed-q5-1m-4x"], world=4, seed=7,
                    fault="_faults:exchange_left_out")
    assert not res["correct"]


def test_keyed_four_ranks_cold_keys_dropped(tiny, four_card_root):
    """Bids of odd keys left out on each rank's last owner shard: the hot
    items read right, and the state's key counts, gathered over the ranks,
    do not."""
    res = run_ranks(four_card_root, "keyed-q5-1m-4x", tiny["keyed-q5-1m-4x"], world=4, seed=7,
                    fault="_faults:cold_keys_dropped")
    c = res["checks"]
    assert c["wrong_window_values"]["value"] == 0 and c["wrong_key_counts"]["value"] > 0, c
    assert not res["correct"]


def test_keyed_four_ranks_control_readings(tiny, four_card_root):
    from holonbench import control

    rows = run_ranks(four_card_root, "keyed-q5-1m-4x", tiny["keyed-q5-1m-4x"], world=4, seed=0,
                     control_seeds=(9, 2**31 + 9))
    s = control.summary(rows)
    assert all(v["lower"] == 0 for v in s.values()), s
    assert s["wrong_window_values"]["upper"] > 0, s
    assert s["wrong_key_counts"]["upper"] > 0, s
