"""RANSAC line fit in numpy (the defaults of sklearn's RANSACRegressor over
a LinearRegression, which the JAX package's dense-depth calibration uses).

``ransac_line(x, y, weight, rng)`` fits y ~ s * x + b robustly:

* minimal sets of 2 points drawn without replacement from ``rng`` (an
  explicit np.random.Generator), each fitted exactly;
* a point is an inlier when |y - s x - b| <= the median absolute deviation
  of y;
* the candidate with the most inliers wins, ties going to the higher R^2
  on its inliers;
* at most 100 trials, stopping early once the trial count reaches
  ceil(log(0.01) / log(1 - w^2)) for the best inlier share w
  (sklearn's _dynamic_max_trials at stop_probability 0.99);
* the result is the weighted least-squares line through the best
  candidate's inliers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_EPS = np.spacing(1)
MAX_TRIALS = 100
STOP_PROBABILITY = 0.99


def _line(x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None):
    """(slope, intercept) of the (weighted) least-squares line; a vertical
    set (one x) gets slope 0 and the mean of y, as LinearRegression's
    minimum-norm solution does."""
    w = np.ones_like(x) if w is None else w
    sw = w.sum()
    mx, my = (w * x).sum() / sw, (w * y).sum() / sw
    dx = x - mx
    sxx = (w * dx * dx).sum()
    s = (w * dx * (y - my)).sum() / sxx if sxx > 0 else 0.0
    return float(s), float(my - s * mx)


def _r2(x, y, s, b) -> float:
    res = ((y - (s * x + b)) ** 2).sum()
    tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - res / tot if tot > 0 else (1.0 if res == 0 else 0.0)


def _max_trials(n_inliers: int, n: int) -> float:
    nom = max(_EPS, 1 - STOP_PROBABILITY)
    denom = max(_EPS, 1 - (n_inliers / n) ** 2)
    if nom == 1:
        return 0
    if denom == 1:
        return float("inf")
    return abs(float(np.ceil(np.log(nom) / np.log(denom))))


def ransac_line(x: np.ndarray, y: np.ndarray, weight: Optional[np.ndarray],
                rng: np.random.Generator) -> Tuple[float, float]:
    """(slope, intercept) of the robust fit y ~ slope * x + intercept; x, y
    [N] with N >= 2; weight [N] (or None) weights the final fit; rng draws
    the minimal sets."""
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(x)
    if n < 2:
        raise ValueError(f"ransac_line: {n} points, needs at least 2")
    w = None if weight is None else np.asarray(weight, np.float64).reshape(-1)
    threshold = np.median(np.abs(y - np.median(y)))
    best_n, best_score, best = 1, -np.inf, None
    trials, limit = 0, MAX_TRIALS
    while trials < limit:
        trials += 1
        i = rng.choice(n, 2, replace=False)
        s, b = _line(x[i], y[i])
        inl = np.abs(y - (s * x + b)) <= threshold
        k = int(inl.sum())
        if k < best_n:
            continue
        score = _r2(x[inl], y[inl], s, b)
        if k == best_n and score < best_score:
            continue
        best_n, best_score, best = k, score, inl
        limit = min(limit, _max_trials(best_n, n))
    if best is None:
        raise ValueError("ransac_line: no candidate had an inlier")
    return _line(x[best], y[best], None if w is None else w[best])
