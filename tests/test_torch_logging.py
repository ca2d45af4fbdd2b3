"""The port's EpochLogger (`mgtpu_torch/utils/logging.py`) — header
adoption on resume and column evolution, the cases of
tests/test_logging.py
(the reference's optim.Logger kept log-file fidelity; VERDICT r2 asked
for new-key rows to extend the header instead of dropping values)."""

import math

from mgtpu_torch.utils.logging import EpochLogger


def _read(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


def test_torch_logger_basic_rows(tmp_path):
    p = str(tmp_path / "train.log")
    lg = EpochLogger(p)
    lg.add({"loss": 1.5, "top1": 0.25})
    lg.add({"loss": 1.25, "top1": 0.5})
    header, rows = _read(p)
    assert header == ["loss", "top1"]
    assert float(rows[1][0]) == 1.25


def test_torch_logger_resume_adopts_existing_header(tmp_path):
    p = str(tmp_path / "train.log")
    EpochLogger(p).add({"b": 1.0, "a": 2.0})
    lg2 = EpochLogger(p)  # fresh process resuming the run dir
    lg2.add({"a": 3.0, "b": 4.0})
    header, rows = _read(p)
    assert header == ["a", "b"]
    assert [float(v) for v in rows[1]] == [3.0, 4.0]


def test_torch_logger_new_columns_rewrite_not_drop(tmp_path):
    """A metric added mid-run (e.g. -tenCrop on resume) extends the
    header; old rows read nan in the new column, nothing is lost."""
    p = str(tmp_path / "test.log")
    lg = EpochLogger(p)
    lg.add({"loss": 1.0})
    lg.add({"loss": 0.5, "top5": 0.9})
    header, rows = _read(p)
    assert header == ["loss", "top5"]
    assert float(rows[0][0]) == 1.0 and math.isnan(float(rows[0][1]))
    assert [float(v) for v in rows[1]] == [0.5, 0.9]
    # missing keys in later rows still pad with nan (columns persist)
    lg.add({"loss": 0.25})
    _, rows = _read(p)
    assert math.isnan(float(rows[2][1]))
