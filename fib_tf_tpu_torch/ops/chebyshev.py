"""Chebyshev polynomial rate approximation (port of
fib_tf_tpu/ops/chebyshev.py).

At definition time each voltage-dependent rate is least-squares fitted by
a degree-8 Chebyshev polynomial in numpy and converted to the basis of
leading terms S_i (S_0 = 1, S_i = 2x*S_{i-1}); at run time only the S_i
product chain and a weighted sum remain.  `chebyshev_fit` is the JAX
package's numpy arithmetic verbatim (including the `a //= diag` basis
change), so both packages bake bit-identical coefficients.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def chebyshev_fit(x: np.ndarray, y: np.ndarray, deg: int = 8) -> np.ndarray:
    """Fit y(x) and return float64 coefficients in the S_i basis."""
    c = np.polynomial.chebyshev.Chebyshev.fit(x, y, deg).coef

    # a[i, j] = coefficient of x^j in T_i
    a = np.zeros([deg + 1, deg + 1], dtype=np.int64)
    a[0, 0] = 1                      # T_0 = 1
    a[1, 1] = 1                      # T_1 = x
    for i in range(2, deg + 1):
        a[i, 1:] += 2 * a[i - 1, :-1]   # + 2x T_{i-1}
        a[i, :] -= a[i - 2, :]          # -  T_{i-2}
    # numpy broadcasting: column j divided by a[j, j] = 2^(j-1); exact for
    # Chebyshev coefficient columns, so this is the T->S basis change.
    diag = np.diag(a).copy()
    a //= diag
    d = a.T @ c
    return d.astype(np.float64)


def chebyshev_terms(x: torch.Tensor, deg: int) -> List[torch.Tensor]:
    """Leading-term chain [S_0 .. S_deg]: S_0 = 1, S_1 = x,
    S_i = (2x) * S_{i-1}."""
    if deg < 2:
        raise ValueError(f"deg must be > 1 (got {deg})")
    terms = [torch.ones_like(x), x]
    for _ in range(deg - 1):
        terms.append(2.0 * x * terms[-1])
    return terms


def chebyshev_eval(d: np.ndarray, terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """Evaluate sum_i d_i S_i with float32 coefficients, accumulated in
    the order of fib_tf_tpu.ops.chebyshev.chebyshev_eval."""
    d32 = np.asarray(d, np.float32)
    r = torch.full_like(terms[1], float(d32[0]))
    for i in range(1, len(d32)):
        r = r + float(d32[i]) * terms[i]
    return r


def normalize_voltage(v: torch.Tensor, min_v: float, max_v: float) -> torch.Tensor:
    """Map voltage from [min_v, max_v] to the Chebyshev domain [-1, 1]."""
    mid = 0.5 * (max_v + min_v)
    half = 0.5 * (max_v - min_v)
    return (v - mid) / half
