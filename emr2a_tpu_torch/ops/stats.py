"""StandardScaler and PCA on tensors, fitted on the training rows only.

Port of ``emr2a_tpu/ops/stats.py``, the fold whitening of the CV evaluator
(StandardScaler -> PCA -> row L2), with the same rules:

- the scaler's variance has ddof = 0; a feature whose std is below 10 * eps
  of its dtype scales by 1 (sklearn's ``_handle_zeros_in_scale``);
- PCA centres, takes a thin SVD in at least f32 (a bf16 input is raised to
  f32; an f64 input stays f64), and fixes the signs as sklearn's
  ``svd_flip(u_based_decision=False)``: the largest-magnitude element of
  each component row is made positive (the first one on a tie).

Everything runs on the tensors' own device; ``torch.linalg.svd`` on the
card is a library call outside any kernel, as the SVD is in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ScalerState(NamedTuple):
    mean: torch.Tensor   # (dim,)
    scale: torch.Tensor  # (dim,) std with near-zeros replaced by 1


class PCAState(NamedTuple):
    mean: torch.Tensor        # (dim,)
    components: torch.Tensor  # (n_components, dim)


class StandardScaler:
    """fit / transform over the functional core, as sklearn's."""

    def __init__(self) -> None:
        self.state: Optional[ScalerState] = None

    def fit(self, x) -> "StandardScaler":
        self.state = scaler_fit(torch.as_tensor(x))
        return self

    def transform(self, x) -> torch.Tensor:
        assert self.state is not None, "fit() first"
        return scaler_transform(self.state, torch.as_tensor(x))

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)


class PCA:

    def __init__(self, n_components: int) -> None:
        self.n_components = n_components
        self.state: Optional[PCAState] = None

    def fit(self, x) -> "PCA":
        self.state = pca_fit(torch.as_tensor(x), self.n_components)
        return self

    def transform(self, x) -> torch.Tensor:
        assert self.state is not None, "fit() first"
        return pca_transform(self.state, torch.as_tensor(x))

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)


def scaler_fit(x: torch.Tensor) -> ScalerState:
    mean = x.mean(dim=0)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=0))
    tiny = 10 * torch.finfo(std.dtype).eps
    scale = torch.where(std < tiny, torch.ones_like(std), std)
    return ScalerState(mean=mean, scale=scale)


def scaler_transform(state: ScalerState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) / state.scale


def pca_fit(x: torch.Tensor, n_components: int) -> PCAState:
    mean = x.mean(dim=0)
    centered = x - mean
    if centered.dtype != torch.float64:
        centered = centered.float()
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    max_abs_cols = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device),
                          max_abs_cols])
    vt = vt * signs[:, None]
    return PCAState(mean=mean, components=vt[:n_components])


def pca_transform(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean) @ state.components.T


def _l2_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)


def fit_whiten_transform(train: torch.Tensor, test: torch.Tensor,
                         pca_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """StandardScaler (fit on train) -> PCA (fit on train) -> row L2 of
    both. ``pca_dim`` is already clamped by the caller to
    min(requested, n_train - 1, dim) and is positive; the caller takes
    ``whiten_no_pca`` otherwise."""
    sstate = scaler_fit(train)
    train_s = scaler_transform(sstate, train)
    test_s = scaler_transform(sstate, test)
    pstate = pca_fit(train_s, pca_dim)
    return (_l2_rows(pca_transform(pstate, train_s)),
            _l2_rows(pca_transform(pstate, test_s)))


def whiten_no_pca(train: torch.Tensor, test: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaler + row L2 without PCA (the n_components <= 0 branch)."""
    sstate = scaler_fit(train)
    return (_l2_rows(scaler_transform(sstate, train)),
            _l2_rows(scaler_transform(sstate, test)))
