"""first_prove_s (setup layer): host seconds of the first
``CompiledCircuit.verify`` after compile, which builds round 3's tables."""


def read(run):
    return run.first_prove_s
