"""Host milliseconds from a call into the program's entry (`Trainer.step`) to
its return, the mean over the window's calls: the benchmark's own span."""

UNIT = "ms"


def read(r):
    if r.driver != "train" or not r.dispatch:
        return None
    return sum(r.dispatch) / len(r.dispatch) * 1e3
