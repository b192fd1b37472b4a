"""runner_builds.<unit>: the ``ntt.runner.build`` spans in the traced
window, the runners ``api.ntt`` built on a cache miss there: 0 where
set-up built every runner the window uses. None where the window holds no
``ntt.api`` span."""

from gpubench import spans


def read(run):
    s = spans.of(run.trace)
    return None if s is None else float(s.counts[spans.RUNNER_BUILD])
