"""The port's evaluation CLI against the repository's ``test.py`` on the
inverse problems besides BWE: ``inpainting``, ``declipping``,
``phase_retrieval`` and ``comp_sens`` (the helper, the inputs and what is
compared are ``tests/test_torch_test_cli.py``'s): the same files, finite
wavs, and no ``metrics.jsonl`` records in either package."""

import torch
import pytest

from test_torch_test_cli import check_files_and_records, inputs, records, \
    run_both

__all__ = ["inputs"]  # the fixture, shared with the CLI tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here: the suite shares the CPU among several
    workers (these shapes gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_inverse_problem_modes(inputs):
    jdir, tdir = run_both(inputs, ["inpainting", "declipping",
                                   "phase_retrieval", "comp_sens"])
    check_files_and_records(jdir, tdir)
    assert records(tdir) == []
    assert {p.parent.name for p in (tdir / "outputs").rglob("*.wav")} == {
        "inpainting", "bwe_declipped", "bwe_pr", "bwe_cs"}
