"""The reader of ``null_pair_skip_pct``, on a pair-step counter set by hand:
100 (1 - live / scheduled), and None where the program gives it nothing to
read (no such counter, no card, no sweep yet)."""

import pytest
import torch

from portbench import run
from timecrystal_tpu_torch.ops import jacobi_svd

READER = run.BENCH_DIR / "metrics" / "null_pair_skip_pct.py"
NAMES = ("null_pair_skip_pct.drive", "null_pair_skip_pct.window")


def _read(monkeypatch, name, counts, card=True):
    """The reader's value with the program's counter reading ``counts``
    ([live, scheduled], or None: no counter) on a card (or none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if counts is None:
        monkeypatch.delattr(jacobi_svd, "pair_step_counter")
    else:
        monkeypatch.setattr(jacobi_svd, "pair_step_counter",
                            lambda device: torch.tensor(counts, dtype=torch.int64))
    assert run._reader_path(run.ROOT, name) == READER
    return run._read_metric(READER, name, run.Window(1.0, [], None))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("live,scheduled", [(1128, 4560), (4560, 4560), (0, 280)])
def test_null_pair_skip_pct_reads_the_pair_step_counter(monkeypatch, name, live,
                                                        scheduled):
    got = _read(monkeypatch, name, [live, scheduled])
    assert got == pytest.approx(100.0 * (1.0 - live / scheduled), abs=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no_counter", "no_card", "no_sweep"])
def test_null_pair_skip_pct_is_none_without_counts(monkeypatch, name, case):
    counts = {"no_counter": None, "no_card": [5, 10], "no_sweep": [0, 0]}[case]
    assert _read(monkeypatch, name, counts, card=case != "no_card") is None
