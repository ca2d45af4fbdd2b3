"""Host milliseconds from a call into the program's entry (`Server.predict`) to
its return, the mean over the window's calls: the benchmark's own span."""

UNIT = "ms"


def read(r):
    if r.driver != "serve" or not r.dispatch:
        return None
    return sum(r.dispatch) / len(r.dispatch) * 1e3
