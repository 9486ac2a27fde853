"""PCA and t-SNE on the device: the port's counterpart of the scikit-learn
calls of ``pti_ldm_vae_tpu/analysis/latent_space.py`` (``PCA(n)`` and
``TSNE(n_components, perplexity, init="pca", random_state)``), written in
torch after scikit-learn 1.9's algorithms (``decomposition/_pca.py``,
``manifold/_t_sne.py``, ``manifold/_utils.pyx``).

* ``PCA``: mean and top-k principal axes, computed exactly in float64 by
  ``eigh`` of the smaller of the Gram and covariance matrices; signs by
  scikit-learn's ``svd_flip(u_based_decision=False)`` (the largest-magnitude
  entry of each component is positive). scikit-learn's ``"auto"`` solver is
  exact up to 500 samples and randomized (``random_state=None``: a different
  approximation each run) above that at the analysis CLIs' widths; this one is
  exact at every size.
* ``joint_probabilities``: the t-SNE affinities P of the Barnes-Hut path:
  ``k = min(N - 1, int(3 * perplexity + 1))`` nearest neighbours on squared
  Euclidean distances (matmul form, float64, no ``[N, N, D]`` tensor), the
  per-row bisection of ``_binary_search_perplexity`` vectorised over the rows
  (100 steps, tolerance 1e-5 on the entropy in nats), then
  ``P = (P + P^T) / max(sum, eps)``; returned dense ``[N, N]`` float64.
* ``TSNE``: PCA init scaled to ``std(PC1) = 1e-4`` in float32, one degree
  of freedom, learning rate ``"auto"`` (``max(N / 12 / 4, 50)``), 250
  iterations with P x 12 at momentum 0.5, then momentum 0.8 up to
  ``max_iter``, gains +0.2 / x0.8 (at least 0.01), a check every 50
  iterations (``n_iter_without_progress``, ``min_grad_norm``) as in
  ``_gradient_descent``. The one departure: the repulsive term is summed
  exactly over all pairs (the ``angle -> 0`` limit of the Barnes-Hut tree),
  in float32 ``[N, N]`` matrices, so the embedding is deterministic.
* ``kl_divergence`` and ``trustworthiness``: KL(P || Q) of an embedding and
  the rank-based trustworthiness of ``sklearn.manifold.trustworthiness``.

Every function runs on ``device`` (CUDA unless the caller asks for the
CPU) and returns torch tensors there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.cli_common import resolve_device

__all__ = ["PCA", "TSNE", "joint_probabilities", "kl_divergence", "kl_gradient",
           "trustworthiness"]

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
# ``_utils.pyx`` keeps these as C floats
EPSILON_DBL = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
BISECTION_STEPS = 100
EXPLORATION_ITERATIONS = 250
CHECK_EVERY = 50


def _as_device_tensor(x, device: torch.device, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


class PCA:
    """Exact PCA in float64 on ``device``; ``fit`` / ``transform`` /
    ``fit_transform`` take ``[N, D]`` arrays or tensors and give ``[N, k]``
    float64 tensors. Attributes as scikit-learn's: ``mean_``,
    ``components_`` ``[k, D]``, ``explained_variance_``,
    ``explained_variance_ratio_``, ``singular_values_``."""

    def __init__(self, n_components: int, *, device: torch.device | str = "cuda") -> None:
        self.n_components = int(n_components)
        self.device = resolve_device(str(device))

    def fit(self, X) -> "PCA":
        x = _as_device_tensor(X, self.device)
        if x.ndim != 2:
            raise ValueError(f"Expected 2D array, got {x.ndim}D array")
        n, d = x.shape
        k = self.n_components
        if not 0 < k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 1 and min(n_samples, "
                             f"n_features)={min(n, d)}")
        self.mean_ = x.mean(dim=0)
        xc = x - self.mean_
        if n <= d:  # eigenvectors of the Gram matrix are the left singular vectors
            evals, evecs = torch.linalg.eigh(xc @ xc.T)
            evals, u = evals.flip(0)[:k].clamp_min(0.0), evecs.flip(1)[:, :k]
            s = evals.sqrt()
            vt = (xc.T @ u).T / torch.where(s > 0, s, torch.ones_like(s))[:, None]
        else:  # eigenvectors of the covariance matrix are the right singular vectors
            evals, evecs = torch.linalg.eigh(xc.T @ xc)
            evals, vt = evals.flip(0)[:k].clamp_min(0.0), evecs.flip(1)[:, :k].T
            s = evals.sqrt()
        # svd_flip(u_based_decision=False): each component's largest-magnitude entry > 0
        pivot = vt.abs().argmax(dim=1)
        signs = torch.sign(vt.gather(1, pivot[:, None]))
        self.components_ = vt * torch.where(signs == 0, torch.ones_like(signs), signs)
        self.singular_values_ = s
        self.explained_variance_ = evals / (n - 1)
        self.explained_variance_ratio_ = self.explained_variance_ / (
            xc.square().sum() / (n - 1))
        return self

    def transform(self, X) -> torch.Tensor:
        return (_as_device_tensor(X, self.device) - self.mean_) @ self.components_.T

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)


def _squared_distances(x: torch.Tensor) -> torch.Tensor:
    """``[N, N]`` squared Euclidean distances in the matmul form, clipped at 0."""
    sq = x.square().sum(dim=1)
    return (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min_(0.0)


def _binary_search_perplexity(sqdist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Conditional P of each row (``_utils.pyx:_binary_search_perplexity``),
    all rows at once: a row stops where its entropy is within the tolerance
    and keeps the probabilities of that step."""
    n = sqdist.shape[0]
    desired_entropy = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=sqdist.dtype, device=sqdist.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=sqdist.device)
    cond = torch.zeros_like(sqdist)
    for _ in range(BISECTION_STEPS):
        p = torch.exp(-sqdist * beta[:, None])
        sum_p = p.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, torch.full_like(sum_p, EPSILON_DBL), sum_p)
        p = p / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (sqdist * p).sum(dim=1)
        diff = entropy - desired_entropy
        cond = torch.where(active[:, None], p, cond)
        move = active & (diff.abs() > PERPLEXITY_TOLERANCE)
        up, down = move & (diff > 0.0), move & (diff <= 0.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(
            up, torch.where(beta_max == math.inf, beta * 2.0, (beta + beta_max) / 2.0),
            torch.where(down, torch.where(beta_min == -math.inf, beta / 2.0,
                                          (beta + beta_min) / 2.0), beta))
        active = move
        if not bool(active.any()):
            break
    return cond


def joint_probabilities(X, perplexity: float, *, device: torch.device | str = "cuda"
                        ) -> torch.Tensor:
    """Symmetric t-SNE affinities P ``[N, N]`` (float64) of ``X`` ``[N, D]``
    from its ``min(N - 1, int(3 * perplexity + 1))`` nearest neighbours
    (``_t_sne.py:_fit`` and ``_joint_probabilities_nn``)."""
    device = resolve_device(str(device))
    x = _as_device_tensor(X, device)
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    sqdist = _squared_distances(x)
    sqdist.fill_diagonal_(math.inf)
    knn_sqdist, knn = torch.topk(sqdist, k, dim=1, largest=False, sorted=True)
    del sqdist
    cond = _binary_search_perplexity(knn_sqdist, perplexity)
    p = torch.zeros(n, n, dtype=cond.dtype, device=device).scatter_(1, knn, cond)
    p = p + p.T
    return p / p.sum().clamp_min(MACHINE_EPSILON)


def _student_t(y: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Per-component differences ``y_i - y_j`` and the kernel
    ``w_ij = 1 / (1 + |y_i - y_j|^2)`` (zero diagonal), ``[N, N]`` each."""
    diffs = [y[:, c, None] - y[None, :, c] for c in range(y.shape[1])]
    w = 1.0 / (1.0 + sum(d.square() for d in diffs))
    return diffs, w.fill_diagonal_(0.0)


def _kl(p: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """sum over P > 0 of ``p log(max(p, tiny) / max(w / Z, tiny))`` (float64)."""
    p64 = p.to(torch.float64)
    q = (w.to(torch.float64) / z).clamp_min(FLOAT32_TINY)
    terms = p64 * torch.log(p64.clamp_min(FLOAT32_TINY) / q)
    return torch.where(p64 > 0, terms, torch.zeros_like(terms)).sum()


def kl_gradient(p: torch.Tensor, y: torch.Tensor, compute_error: bool = True
                ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """KL(P || Q) and its gradient with respect to the embedding ``y``
    ``[N, c]`` for one degree of freedom, with the repulsion summed exactly
    over all pairs: ``4 sum_j (p_ij w_ij - w_ij^2 / Z)(y_i - y_j)``, ``Z`` the
    sum of ``w`` in float64 (the ``_kl_divergence_bh`` gradient at
    ``angle=0``). ``p`` and ``y`` share a dtype; the error is None unless
    asked for."""
    diffs, w = _student_t(y)
    z = w.sum(dtype=torch.float64).clamp_min(MACHINE_EPSILON)
    a = p * w - w.square() / z.to(w.dtype)
    grad = torch.stack([(a * d).sum(dim=1) for d in diffs], dim=1) * 4.0
    return (_kl(p, w, z) if compute_error else None), grad


def kl_divergence(P, Y, *, device: torch.device | str = "cuda") -> float:
    """KL(P || Q) of embedding ``Y`` under affinities ``P``, exact Q, float64."""
    device = resolve_device(str(device))
    p, y = _as_device_tensor(P, device), _as_device_tensor(Y, device)
    _, w = _student_t(y)
    return float(_kl(p, w, w.sum().clamp_min(MACHINE_EPSILON)))


def trustworthiness(X, X_embedded, *, n_neighbors: int = 5,
                    device: torch.device | str = "cuda") -> float:
    """``sklearn.manifold.trustworthiness`` (Euclidean): how far the
    ``n_neighbors`` nearest neighbours in the embedding are also near in the
    input, penalised by their input rank beyond ``n_neighbors``."""
    device = resolve_device(str(device))
    x, y = _as_device_tensor(X, device), _as_device_tensor(X_embedded, device)
    n = x.shape[0]
    if n_neighbors >= n / 2:
        raise ValueError(f"n_neighbors ({n_neighbors}) should be less than n_samples / 2 "
                         f"({n / 2})")
    dist_x = _squared_distances(x).fill_diagonal_(math.inf)
    order = torch.argsort(dist_x, dim=1)
    del dist_x
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(1, n + 1, device=device).expand(n, n).contiguous())
    dist_y = _squared_distances(y).fill_diagonal_(math.inf)
    nearest = torch.topk(dist_y, n_neighbors, dim=1, largest=False, sorted=True).indices
    penalty = (rank.gather(1, nearest) - n_neighbors).clamp_min(0).sum()
    k = n_neighbors
    return 1.0 - float(penalty) * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


class TSNE:
    """t-SNE as ``sklearn.manifold.TSNE(n_components, perplexity=...,
    init="pca", random_state=...)`` runs it with its 1.9 defaults, with the
    exact repulsive term (module docstring). ``random_state`` reaches only the
    PCA init, which is exact here, so the result does not depend on it; it is
    taken for the API. After ``fit_transform``: ``embedding_``,
    ``kl_divergence_``, ``n_iter_``, ``learning_rate_``."""

    EARLY_EXAGGERATION = 12.0
    N_ITER_WITHOUT_PROGRESS = 300
    MIN_GRAD_NORM = 1e-7

    def __init__(self, n_components: int = 2, *, perplexity: float = 30.0,
                 max_iter: int = 1000, random_state=None,
                 device: torch.device | str = "cuda") -> None:
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.random_state = random_state
        self.device = resolve_device(str(device))

    def _initial_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """PCA of ``x`` in float32, PC1 scaled to standard deviation 1e-4
        (``_t_sne.py``: the scale of its random init)."""
        y = PCA(self.n_components, device=self.device).fit_transform(x).to(torch.float32)
        return y / y[:, 0].std(correction=0) * 1e-4

    def _descend(self, p: torch.Tensor, y: torch.Tensor, it: int, max_iter: int,
                 momentum: float, n_iter_without_progress: int) -> tuple[float, int]:
        """``_gradient_descent`` in place on ``y``: the update accumulates in
        float64 (scikit-learn's ``learning_rate_`` is a float64 scalar, which
        promotes it; here the step ``learning_rate_ * grad`` itself is
        rounded to float32 first), embedding and gains in float32; the error
        and gradient norm read every ``CHECK_EVERY`` iterations."""
        update = torch.zeros(y.shape, dtype=torch.float64, device=y.device)
        gains = torch.ones_like(y)
        error = best_error = float(np.finfo(float).max)
        best_iter = i = it
        for i in range(it, max_iter):
            check = (i + 1) % CHECK_EVERY == 0
            err, grad = kl_gradient(p, y, compute_error=check or i == max_iter - 1)
            inc = update * grad < 0.0
            gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min_(0.01)
            grad = grad * gains
            update = momentum * update - self.learning_rate_ * grad
            y.copy_(y.to(torch.float64) + update)  # numpy's ``p += update``: add in float64
            if err is not None:
                error = float(err)
            if check:
                grad_norm = float(torch.linalg.vector_norm(grad))
                if error < best_error:
                    best_error, best_iter = error, i
                elif i - best_iter > n_iter_without_progress:
                    break
                if grad_norm <= self.MIN_GRAD_NORM:
                    break
        return error, i

    def fit_transform(self, X) -> torch.Tensor:
        """The ``[N, n_components]`` float32 embedding of ``X`` ``[N, D]``."""
        x = _as_device_tensor(X, self.device)
        if self.perplexity >= x.shape[0]:
            raise ValueError(f"perplexity ({self.perplexity}) must be less than n_samples "
                             f"({x.shape[0]})")
        return self.embed(joint_probabilities(x, self.perplexity, device=self.device), x)

    def embed(self, P: torch.Tensor, X) -> torch.Tensor:
        """The optimisation alone, from affinities ``P`` (``joint_probabilities``
        of ``X``): the init from ``X``, then both stages."""
        x = _as_device_tensor(X, self.device)
        n = x.shape[0]
        self.learning_rate_ = max(n / self.EARLY_EXAGGERATION / 4, 50.0)  # "auto"
        y = self._initial_embedding(x)
        # stage 1: early exaggeration at momentum 0.5; stage 2: momentum 0.8
        p = (P * self.EARLY_EXAGGERATION).to(torch.float32)
        error, it = self._descend(p, y, 0, EXPLORATION_ITERATIONS, 0.5, EXPLORATION_ITERATIONS)
        p = P.to(torch.float32)
        if it < EXPLORATION_ITERATIONS or self.max_iter > EXPLORATION_ITERATIONS:
            error, it = self._descend(p, y, it + 1, self.max_iter, 0.8,
                                      self.N_ITER_WITHOUT_PROGRESS)
        self.n_iter_ = it
        self.kl_divergence_ = error
        self.embedding_ = y
        return y
