"""The crash schedule of `chip_smoke.py` phase 13's seed-7 run, on a CPU
engine: which peers the failure detector evicts.

    PYTHONPATH=src python tests/torch_c2_witness.py reference-numpy
    PYTHONPATH=src python tests/torch_c2_witness.py reference-jax
    PYTHONPATH=src python tests/torch_c2_witness.py port-numpy

Majority at n = 100,000 on ring seed 7 (votes at mu = 0.45 from the same
generator, engine seed 8), armed with suspect 25 / evict 150: converge,
crash 16 peers at rows spread over 1,000..99,000, then step in 25-cycle
dispatches until every crashed peer is evicted and 8 dispatches more.
Prints each eviction as (cycles after the crash, address, crashed?) and
the live peers evicted. `reference-numpy` is the reference's
`NumpyEngine` (a few minutes); `reference-jax` its
`JaxEngine(kernel="ref", wheel_kernels="none")`, bit-identical to the
port's torch engine (hours on a CPU); `port-numpy` the port's copy of
the numpy engine. Not collected by pytest.
"""
from __future__ import annotations

import sys
import time

import numpy as np

N = 100_000


def build(which: str, votes: np.ndarray):
    if which.startswith("reference"):
        from repro.core.dht import Ring
        from repro.engine import make_engine
        from repro.engine.base import FaultConfig
    else:
        from repro_torch.core.dht import Ring
        from repro_torch.engine import FaultConfig, make_engine
    backend = "jax" if which == "reference-jax" else "numpy"
    kw = (dict(kernel="ref", wheel_kernels="none", capacity_per_peer=8)
          if backend == "jax" else {})
    return make_engine(backend, Ring.random(N, 32, seed=7), votes, seed=8,
                       faults=FaultConfig(suspect_after=25, evict_after=150),
                       **kw)


def main(which: str) -> None:
    rng = np.random.default_rng(7)
    votes = np.zeros(N, np.int64)
    votes[rng.choice(N, int(round(N * 0.45)), replace=False)] = 1
    eng = build(which, votes)
    t0 = time.time()
    res = eng.run_until_converged(int(2 * votes.sum() >= N))
    print(f"converged {res} at t={eng.t} in {time.time() - t0:.0f} s",
          flush=True)
    victims = [int(i) for i in np.linspace(1000, N - 1000, 16)]
    gone = {int(eng.ring.addrs[i]) for i in victims}
    for i in victims:
        eng.crash(i)
    t_crash, extra = eng.t, 0
    evicted = lambda: {a for _, a in eng.evictions}
    while eng.t - t_crash < 20 * 256 and extra < 8:
        eng.step(25)
        extra += gone <= evicted()
    print(which, "evictions", [(c - t_crash, a, a in gone)
                               for c, a in eng.evictions])
    print("live evicted", sorted(evicted() - gone), "crashed not evicted",
          sorted(gone - evicted()), f"({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main(sys.argv[1])
