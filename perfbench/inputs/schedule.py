"""The open-loop request schedule: when each request is due, how many
nodes it asks for, and which.

Every seed gets the same multiset of inter-arrival gaps and request sizes,
drawn once from the traffic file's ``base_seed``, in an order drawn from
the run's seed: so the work offered is the same in every run, and only its
order differs. Gaps are exponential (Poisson arrivals) at ``rate`` requests
per second, rescaled to sum to the window: the first request is due when
the window opens, and the last gap ends when it closes. Sizes are log-uniform over ``[size_min, size_max]``. Ids are drawn
from the run's seed: Zipf with exponent ``zipf_exponent`` over a seeded
permutation of the pool (the test split, nodes no training step saw).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.inputs.seeds import sub_seed


@dataclasses.dataclass
class Schedule:
    due: np.ndarray  # seconds after the window opens, ascending
    sizes: np.ndarray  # nodes per request
    ids: list  # one int64 array per request

    def __len__(self) -> int:
        return len(self.due)

    def head(self, n: int) -> "Schedule":
        """The first ``n`` requests, due as in the whole schedule."""
        return Schedule(due=self.due[:n], sizes=self.sizes[:n], ids=self.ids[:n])


def log_uniform_sizes(rng: np.random.Generator, count: int, lo: int, hi: int) -> np.ndarray:
    u = rng.uniform(np.log(lo), np.log(hi + 1), size=count)
    return np.clip(np.floor(np.exp(u)).astype(np.int64), lo, hi)


def zipf_ids(rng: np.random.Generator, pool: np.ndarray, sizes: np.ndarray,
             exponent: float) -> list:
    """Ids for each request: rank ``r`` of a permutation of ``pool`` with
    probability proportional to ``r ** -exponent``."""
    ranked = rng.permutation(pool)
    w = np.arange(1, len(ranked) + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    flat = ranked[np.minimum(np.searchsorted(cdf, rng.random(int(sizes.sum()))),
                             len(ranked) - 1)]
    return np.split(flat.astype(np.int64), np.cumsum(sizes)[:-1])


def make_schedule(traffic: dict, seconds: float, seed: int, pool: np.ndarray) -> Schedule:
    count = max(int(round(traffic["rate"] * seconds)), 1)
    base = np.random.default_rng(traffic["base_seed"])
    gaps = base.exponential(1.0, size=count)
    sizes = log_uniform_sizes(base, count, traffic["size_min"], traffic["size_max"])
    rng = np.random.default_rng(sub_seed(seed, "schedule"))
    gaps = gaps[rng.permutation(count)] * (seconds / gaps.sum())
    # The first request is due at 0; the last gap runs to the window's end.
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = sizes[rng.permutation(count)]
    return Schedule(due=due, sizes=sizes,
                    ids=zipf_ids(rng, pool, sizes, traffic["zipf_exponent"]))
