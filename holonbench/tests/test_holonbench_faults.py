"""The check that decides ``correct`` fails what it must: each fault the
cells can have, planted under the timed path of a whole run on the CPU at a
tiny size (the harness's look for a card skipped, the kernels' plain
versions), and the control.  A sound run of the same size is correct."""
import pytest

import _faults
from holonbench import bench
from holonbench.cell import find_cell

CELLS = ("dense-q5-10k", "keyed-q5-1m")
FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "answer_altered",
          "cold_keys_dropped")


def run(name, scale, seed, **kw):
    opt = bench.Options(seed=seed, seconds=0.5, device="cpu", scale=scale[name], **kw)
    return bench.run(find_cell(name), opt)


@pytest.fixture
def planted():
    yield getattr
    _faults.restore()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny):
    res = run(name, tiny, seed=2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, tiny, planted):
    planted(_faults, fault)()
    res = run(name, tiny, seed=17)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_cold_fault_caught_by_the_state_alone(name, tiny, planted):
    """Bids left out on one row, away from the hot key: every window's hot
    item still reads right, and only the state's key counts show it."""
    planted(_faults, "cold_keys_dropped")()
    res = run(name, tiny, seed=2**31 + 5)
    c = res["checks"]
    assert c["early_or_missing_windows"]["value"] == c["wrong_window_values"]["value"] == 0, c
    assert c["wrong_key_counts"]["value"] > 0 and not res["correct"], c


@pytest.mark.parametrize("name", CELLS)
def test_control_readings_separate(name, tiny):
    """The control, the reference with bf16 counters in the program's place,
    is not correct: ``control.py``'s readings at a tiny size, where the
    program reads 0 on every number and the control above the limit of 0
    on the window values."""
    from holonbench import control

    rows = control.readings(find_cell(name), [3, 2**31 + 1],
                            bench.Options(seed=0, seconds=0.0, device="cpu", scale=tiny[name]))
    s = control.summary(rows)
    assert all(v["lower"] == 0 for v in s.values()), s
    assert s["wrong_window_values"]["upper"] > 0, s
    assert s["wrong_key_counts"]["upper"] > 0, s
