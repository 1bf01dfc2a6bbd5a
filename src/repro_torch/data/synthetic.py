"""Synthetic dataset generators (paper §5.1.1 stand-ins + §5.3 adversarial).

Pure numpy, drawing in the same order as the JAX package's generators, so
the same seed gives identical data. Row counts scale with ``scale``
(1.0 = paper size):

* intel_wireless — 3 M sensor light readings over a time predicate.
* instacart — 1.4 M `reordered` flags over a Zipf-skewed `product_id`.
* nyc_taxi — 7.7 M trips: lognormal trip_distance over pickup_datetime
  with rush-hour structure; up to five predicate columns (§5.4).
* adversarial — §5.3: 1 M rows, 87.5 % zeros then a normal tail.
"""
from __future__ import annotations

import numpy as np


def intel_wireless(scale: float = 0.1, seed: int = 0):
    n = int(3_000_000 * scale)
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 30 * 86400, size=n))          # one month
    day_phase = (t % 86400) / 86400
    light = (400 + 380 * np.sin(2 * np.pi * (day_phase - 0.3)).clip(0)
             + rng.gamma(2.0, 15.0, size=n))
    spikes = rng.random(n) < 0.002
    light = np.where(spikes, light + rng.uniform(300, 900, size=n), light)
    dropout = rng.random(n) < 0.01
    light = np.where(dropout, 0.0, light)
    return t, light


def instacart(scale: float = 0.1, seed: int = 1):
    n = int(1_400_000 * scale)
    rng = np.random.default_rng(seed)
    num_products = max(1000, int(50_000 * scale))
    pop = rng.zipf(1.3, size=n) % num_products
    product_id = np.sort(pop.astype(np.float64))
    base_rate = rng.beta(2, 3, size=num_products)
    reordered = (rng.random(n) < base_rate[product_id.astype(np.int64)]
                 ).astype(np.float64)
    return product_id, reordered


def nyc_taxi(scale: float = 0.05, seed: int = 2, dims: int = 1):
    n = int(7_700_000 * scale)
    rng = np.random.default_rng(seed)
    day = rng.integers(0, 31, size=n).astype(np.float64)
    hour_w = np.array([1, 1, 1, 1, 1, 2, 4, 7, 8, 6, 5, 5,
                       6, 6, 5, 5, 6, 8, 9, 8, 6, 5, 4, 2], dtype=np.float64)
    hour = rng.choice(24, size=n, p=hour_w / hour_w.sum()).astype(np.float64)
    minute = rng.uniform(0, 60, size=n)
    pickup_t = day * 1440 + hour * 60 + minute
    dist = rng.lognormal(mean=0.9, sigma=0.8, size=n)
    dist = np.clip(dist, 0.0, 80.0)
    long_trip = rng.random(n) < 0.01
    dist = np.where(long_trip, dist * rng.uniform(2, 5, size=n), dist)
    order = np.argsort(pickup_t)
    if dims == 1:
        return pickup_t[order], dist[order]
    cols = [pickup_t, day * 1440 + rng.uniform(0, 1440, size=n),
            rng.integers(1, 266, size=n).astype(np.float64),
            pickup_t + dist * rng.uniform(2, 6, size=n),
            rng.uniform(0, 1440, size=n)]
    c = np.stack(cols[:dims], axis=1)[order]
    return c, dist[order]


def adversarial(n: int = 1_000_000, seed: int = 3, mu: float = 50.0,
                sigma: float = 12.0):
    """Paper §5.3: 87.5 % zeros then a normal tail, unique predicate values."""
    rng = np.random.default_rng(seed)
    c = np.arange(n, dtype=np.float64)
    a = np.zeros(n)
    tail = n - n // 8
    a[tail:] = rng.normal(mu, sigma, size=n - tail)
    return c, a


DATASETS = {
    "intel": intel_wireless,
    "instacart": instacart,
    "nyc_taxi": nyc_taxi,
    "adversarial": adversarial,
}


__all__ = ["intel_wireless", "instacart", "nyc_taxi", "adversarial",
           "DATASETS"]
