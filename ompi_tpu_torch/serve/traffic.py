"""Decode-shaped MoE traffic: seeded Zipf token->expert with a hotness dial
(the port of :mod:`ompi_tpu.serve.traffic`: plain numpy, the port's own
copy, drawing the same seeded streams bit for bit).

Production MoE serving skew is Zipf-shaped — a handful of experts take
most tokens (GShard sec 3.2, Switch-Transformer appendix). The
generator draws expert ids from ``p(rank) ~ rank^-hotness`` over a
seeded random expert permutation, then synthesizes token embeddings
whose router argmax IS the drawn expert: the router matrix is a set of
orthonormal columns (QR of seeded gaussians) and a token for expert e
is ``scale * wg[:, e] + noise``, so ``x @ wg`` peaks at e by
construction. ``hotness=0`` is uniform; ``hotness~1.1`` gives the
classic 8x hot-expert skew the smoke lane asserts on.

Everything is driven by one ``numpy.random.default_rng(seed)`` — two
generators built with the same constructor args produce bitwise-equal
id streams and batches (the determinism test), and every rank of a
multi-controller job builds the same router weights for free.
"""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch import errors


class ZipfTraffic:
    """Seeded Zipf token->expert generator + matching router weights."""

    def __init__(self, n_experts: int, d_model: int, *,
                 hotness: float = 1.1, seed: int = 0,
                 scale: float = 4.0, noise: float = 0.05):
        if n_experts < 1 or d_model < n_experts:
            raise errors.MPIError(
                errors.ERR_ARG,
                f"ZipfTraffic needs 1 <= n_experts <= d_model, got "
                f"n_experts={n_experts} d_model={d_model} (router columns "
                f"are orthonormal, so d_model must cover them)")
        if hotness < 0:
            raise errors.MPIError(
                errors.ERR_ARG, f"hotness must be >= 0, got {hotness}")
        self.n_experts = int(n_experts)
        self.d_model = int(d_model)
        self.hotness = float(hotness)
        self.scale = float(scale)
        self.noise = float(noise)
        rng = np.random.default_rng(seed)
        # which expert sits at each popularity rank (rank 0 = hottest)
        self.perm = rng.permutation(self.n_experts)
        ranks = np.arange(1, self.n_experts + 1, dtype=np.float64)
        w = ranks ** -self.hotness
        self.probs = w / w.sum()
        # orthonormal router columns: token built from column e argmaxes
        # to e under x @ wg (cross terms are exactly 0 pre-noise)
        q, _ = np.linalg.qr(rng.standard_normal((self.d_model,
                                                 self.n_experts)))
        self.wg = np.ascontiguousarray(q[:, :self.n_experts],
                                       dtype=np.float32)
        self._rng = rng

    @property
    def hot_expert(self) -> int:
        """The expert at popularity rank 0 (ground truth for tests)."""
        return int(self.perm[0])

    def expert_ids(self, n_tokens: int) -> np.ndarray:
        """Draw [n_tokens] expert ids from the Zipf distribution."""
        ranks = self._rng.choice(self.n_experts, size=int(n_tokens),
                                 p=self.probs)
        return self.perm[ranks]

    def batch(self, expert_ids: np.ndarray) -> np.ndarray:
        """Token embeddings [T, d_model] that route to ``expert_ids``."""
        ids = np.asarray(expert_ids, dtype=np.int64)
        x = self.wg[:, ids].T * self.scale
        x = x + self.noise * self._rng.standard_normal(x.shape)
        return np.ascontiguousarray(x, dtype=np.float32)

    def request(self, n_tokens: int) -> tuple[np.ndarray, np.ndarray]:
        """One decode request: (expert_ids [T], tokens [T, D])."""
        ids = self.expert_ids(n_tokens)
        return ids, self.batch(ids)
