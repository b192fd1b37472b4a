"""hterm_ms: the window's length over the Groth16 H-terms completed in it,
in ms (host clock): what a SNARK prover waits for on each partition."""


def read(run):
    return 1e3 * run.window.seconds / run.window.units
