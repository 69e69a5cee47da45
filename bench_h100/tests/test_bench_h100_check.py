"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a tiny size (the look for a card skipped): a sound run passes;
the timed path broken underneath fails (``faults.py``: a draw that leaves
its state unchanged, half of the pixels left out of the frame, an answer
altered where it is produced); and the control, the reference in bfloat16
in the program's place, fails."""

import pytest
import torch

import faults
import run

SEED = 4000000007


def tiny(cell: str) -> dict:
    files = run.cell_files(run.load_benchmark(), cell)
    t = files["traffic"]
    t.update(width=48 if t["present"] else 40, height=28 if t["present"] else 24,
             check_pixels=512, warmup_frames=2)
    if files["config"]["dragon_subdivisions"]:
        files["config"]["dragon_subdivisions"] = 4
    return files


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(cell, control=False):
    return run.run_cell(tiny(cell), SEED, 0.2, False, torch.device("cpu"), control=control)


@pytest.mark.parametrize("cell", ["static_dragon1m_1080p", "motion_1080p", "orbit_4k_temporal"])
def test_sound_run_is_correct_and_the_control_is_not(cell):
    import check

    result, detail = run_tiny(cell, control=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    limits = dict(check.LIMITS, **tiny(cell)["traffic"].get("limits", {}))
    ok, _ = check.verdict(detail["control"], limits)
    assert not ok, detail["control"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", ["static_dragon1m_1080p", "orbit_4k_temporal"])
def test_a_broken_timed_path_is_not_correct(fault, cell):
    mend = faults.plant(fault)
    try:
        result, _ = run_tiny(cell)
    finally:
        mend()
    assert not result["correct"], result["checks"]
    assert result["failed"] == 1


@pytest.mark.parametrize("cell", ["static_dragon1m_1080p", "motion_1080p"])
def test_the_first_frames_catch_a_fault_on_every_other_frame(cell):
    """A draw that keeps its state on every other frame passes the last
    frame's check whenever that frame is a sound one (the reference follows
    the program's state); the first frames, worked out from no state of the
    program's, fail it whatever the window's length."""
    import check

    mend = faults.plant("odd_frames_unchanged")
    try:
        result, _ = run_tiny(cell)
    finally:
        mend()
    share, limit = result["checks"]["prefix_mismatch_share"]
    assert share > limit
    assert not result["correct"]
    assert check.LIMITS["prefix_mismatch_share"] == limit
