"""Substitution models from the numbers a configuration file states.

A time-reversible model: exchangeabilities r_ij and stationary frequencies
pi give Q_ij = r_ij pi_j, normalised to one expected substitution per unit
time; discrete Gamma rate categories of equal weight take the mean rate of
each quantile bin (Yang 1994). Both the data generator and the plain
reference use this module; the program under test parses its own model
string.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc, gammaincinv


def exchangeabilities(cfg: dict) -> np.ndarray:
    """[K, K] symmetric exchangeabilities: ``exchangeabilities`` is the
    upper triangle row by row (AC, AG, AT, CG, CT, GT for DNA);
    ``exchangeabilities_lower`` the published PAML layout, row i holding
    the rates of state i against states 0..i-1."""
    K = len(cfg["alphabet"])
    m = np.zeros((K, K))
    if "exchangeabilities" in cfg:
        iu = np.triu_indices(K, k=1)
        m[iu] = np.asarray(cfg["exchangeabilities"], dtype=np.float64)
        m = m + m.T
    else:
        rows = cfg["exchangeabilities_lower"]
        if len(rows) != K - 1:
            raise ValueError("exchangeabilities_lower needs K - 1 rows")
        for i, row in enumerate(rows, start=1):
            if len(row) != i:
                raise ValueError(f"row {i} has {len(row)} entries")
            m[i, :i] = row
            m[:i, i] = row
    return m


def gamma_rates(alpha: float, n: int) -> np.ndarray:
    """Mean rates of ``n`` equiprobable bins of Gamma(alpha, 1/alpha)."""
    if n == 1:
        return np.ones(1)
    cuts = gammaincinv(alpha, np.arange(1, n) / n)
    cdf1 = np.concatenate([[0.0], gammainc(alpha + 1.0, cuts), [1.0]])
    return np.diff(cdf1) * n


class Model:
    """``pmat(t)`` -> [..., R, K, K] transition matrices P(rate_r * t);
    ``A``, ``Ainv``, ``lam`` the eigensystem Q = A diag(lam) Ainv."""

    def __init__(self, cfg: dict):
        self.alphabet = cfg["alphabet"]
        self.K = K = len(self.alphabet)
        freqs = np.asarray(cfg["freqs"], dtype=np.float64)
        self.freqs = freqs / freqs.sum()
        r = exchangeabilities(cfg)
        Q = r * self.freqs[None, :]
        Q[np.diag_indices(K)] = -Q.sum(axis=1)
        Q /= -(self.freqs * np.diag(Q)).sum()
        # symmetrise: D Q D^-1 with D = diag(sqrt(pi)) is symmetric
        d = np.sqrt(self.freqs)
        lam, V = np.linalg.eigh(d[:, None] * Q / d[None, :])
        self.lam = lam
        self.A = V / d[:, None]
        self.Ainv = V.T * d[None, :]
        self.rates = gamma_rates(cfg["gamma_alpha"], cfg["gamma_categories"])
        self.weights = np.full(len(self.rates), 1.0 / len(self.rates))

    @property
    def R(self) -> int:
        return len(self.rates)

    def pmat(self, t) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        e = np.exp(self.lam * self.rates[:, None] * t[..., None, None])
        return np.maximum((self.A * e[..., None, :]) @ self.Ainv, 0.0)
