"""Power-law machinery of FediAC's analysis (Def. 1, Eqs. 2-6, Prop. 1, Cor. 1).

The paper models the sorted magnitudes of a client's model updates as
``|U{l}| <= phi * l**alpha`` (alpha < 0).  From (alpha, phi) and the system
parameters (N clients, vote budget k, threshold a, bits b) it derives:

  p_l   (Eq. 2)  probability one vote lands on the l-th largest coordinate
  q_l   (Eq. 3)  probability client votes coordinate l at least once (k votes)
  r_l   (Eq. 4)  probability the GIA selects coordinate l  (binomial tail >= a)
  gamma (Eq. 5)  compression-error contraction factor of Pi(Theta(f U))
  b_min (Eq. 6)  bit-width lower bound for 0 < gamma < 1

All functions are plain numpy: they run on host as part of the (server-side)
first-iteration tuning step described in paper Sec. IV-D.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "PowerLawFit",
    "fit_power_law",
    "vote_probability",
    "client_vote_probability",
    "gia_selection_probability",
    "expected_uploaded",
    "gamma_compression_error",
    "min_bits",
    "scale_factor",
]


@dataclass(frozen=True)
class PowerLawFit:
    """|U{l}| ~= phi * l**alpha for sorted magnitudes (Def. 1)."""

    alpha: float  # decay exponent, < 0
    phi: float    # scale constant, > 0
    d: int        # dimension the fit was made on

    def magnitudes(self, d: int | None = None) -> np.ndarray:
        d = self.d if d is None else d
        l = np.arange(1, d + 1, dtype=np.float64)
        return self.phi * l ** self.alpha


def fit_power_law(updates: np.ndarray) -> PowerLawFit:
    """Least-squares fit of log|U{l}| = log(phi) + alpha*log(l).

    This is the server-side tuning step of Sec. IV-D: clients report raw
    updates once (t=1), the server fits (alpha, phi) and derives (a, b).
    Zero magnitudes are clipped away (they carry no constraint).
    """
    mags = np.sort(np.abs(np.asarray(updates, dtype=np.float64)).ravel())[::-1]
    d = mags.size
    mags = np.clip(mags, 1e-12, None)
    logl = np.log(np.arange(1, d + 1, dtype=np.float64))
    logm = np.log(mags)
    # ordinary least squares on (logl, logm)
    alpha, logphi = np.polyfit(logl, logm, 1)
    return PowerLawFit(alpha=float(alpha), phi=float(math.exp(logphi)), d=d)


def vote_probability(d: int, alpha: float) -> np.ndarray:
    """Eq. 2:  p_l = l^alpha / sum_{l'} l'^alpha  (one vote)."""
    l = np.arange(1, d + 1, dtype=np.float64)
    w = l ** alpha
    return w / w.sum()


def client_vote_probability(d: int, alpha: float, k: int) -> np.ndarray:
    """Eq. 3:  q_l = 1 - (1 - p_l)^k  (k independent votes)."""
    p = vote_probability(d, alpha)
    return 1.0 - (1.0 - p) ** k


def _binom_tail(n: int, q: np.ndarray, a: int) -> np.ndarray:
    """P[Binomial(n, q) >= a], vectorized over q, exact (n is small: #clients)."""
    a = max(int(a), 0)
    if a <= 0:
        return np.ones_like(q)
    if a > n:
        return np.zeros_like(q)
    q = np.clip(q.astype(np.float64), 0.0, 1.0)
    out = np.zeros_like(q)
    # sum_{j=a}^{n} C(n,j) q^j (1-q)^{n-j}; n <= a few hundred clients -> exact loop.
    for j in range(a, n + 1):
        out += math.comb(n, j) * q ** j * (1.0 - q) ** (n - j)
    return np.clip(out, 0.0, 1.0)


def gia_selection_probability(d: int, alpha: float, k: int, n_clients: int,
                              a: int) -> np.ndarray:
    """Eq. 4:  r_l = P[at least a of N clients vote coordinate l]."""
    q = client_vote_probability(d, alpha, k)
    return _binom_tail(n_clients, q, a)


def expected_uploaded(d: int, alpha: float, k: int, n_clients: int, a: int) -> float:
    """E[k_S] = sum_l r_l — expected number of GIA-selected coordinates."""
    return float(gia_selection_probability(d, alpha, k, n_clients, a).sum())


def scale_factor(b: int, n_clients: int, m: float) -> float:
    """f = (2^{b-1} - N) / (N m)  (paper Sec. IV, step 3)."""
    if m <= 0.0:
        return 1.0
    return (2.0 ** (b - 1) - n_clients) / (n_clients * m)


def gamma_compression_error(d: int, alpha: float, phi: float, k: int,
                            n_clients: int, a: int, b: int,
                            m: float | None = None) -> float:
    """Eq. 5: gamma = 1 - sum(r_l l^2a)/sum(l^2a) + sum(r_l)/(4 f^2 phi^2 sum(l^2a)).

    m defaults to the power-law max magnitude phi (l=1).
    """
    r = gia_selection_probability(d, alpha, k, n_clients, a)
    l = np.arange(1, d + 1, dtype=np.float64)
    l2a = l ** (2.0 * alpha)
    s_l2a = l2a.sum()
    m = phi if m is None else m
    f = scale_factor(b, n_clients, m)
    return float(1.0 - (r * l2a).sum() / s_l2a + r.sum() / (4.0 * f * f * phi * phi * s_l2a))


def min_bits(d: int, alpha: float, phi: float, k: int, n_clients: int, a: int,
             m: float | None = None) -> int:
    """Cor. 1 (Eq. 6): smallest integer b with
    b > log2( sqrt(sum r_l) / (2 phi sqrt(sum r_l l^2a)) * N m + N ) + 1.
    """
    r = gia_selection_probability(d, alpha, k, n_clients, a)
    l = np.arange(1, d + 1, dtype=np.float64)
    l2a = l ** (2.0 * alpha)
    m = phi if m is None else m
    num = math.sqrt(r.sum())
    den = 2.0 * phi * math.sqrt(float((r * l2a).sum()))
    bound = math.log2(num / den * n_clients * m + n_clients) + 1.0
    return int(math.floor(bound)) + 1
