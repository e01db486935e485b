"""NaN-aware keypoint PCA: the fit in numpy on the host, the reprojection in
torch on the keypoints' device (the port's copy of
``lightning_pose_tpu/utils/pca.py``).

- ``KeypointPCA`` takes the train split's keypoints through the dataset's
  resize-only path, formats them (multiview: one row per keypoint across
  views; single view: an optional column subset and centering), fits PCA by
  a masked covariance (``np.ma.cov``) and ``eigh`` with sklearn's sign flip,
  picks the components (multiview: 3; single view: a variance threshold)
  and takes the empirical epsilon as a percentile of the training
  reprojection error. This part is the JAX package's numpy code.
- ``format_data_torch`` and ``reprojection_error_torch`` are the loss-time
  functions, in torch and differentiable; the fitted mean and kept
  eigenvectors are held as tensors, cached per device and type.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "ComponentChooser",
    "EmpiricalEpsilon",
    "KeypointPCA",
    "format_multiview_data_for_pca",
    "nan_pca_fit",
    "nan_pca_transform",
]


def _svd_flip_vt(vt: np.ndarray) -> np.ndarray:
    """sklearn svd_flip with u_based_decision=False: flip each row of Vt so
    its max-|.| entry is positive (reference pca.py:500-501)."""
    max_abs_rows = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_abs_rows])
    signs[signs == 0] = 1.0
    return vt * signs[:, None]


def nan_pca_fit(X: np.ndarray) -> dict[str, np.ndarray]:
    """Fit PCA on data with NaNs via masked covariance + eigh
    (reference pca.py:419-564).

    Returns dict with mean_, components_ (all, sorted desc by eigenvalue),
    explained_variance_, explained_variance_ratio_.
    """
    mean = np.nanmean(X, axis=0)
    C = np.ma.cov(np.ma.masked_invalid(X), rowvar=False).data
    C = np.atleast_2d(C)
    eigenvals, eigenvecs = np.linalg.eigh(C)
    eigenvals = eigenvals[::-1].copy()
    eigenvecs = eigenvecs[:, ::-1].copy()
    eigenvals[eigenvals < 0.0] = 0.0
    vt = _svd_flip_vt(eigenvecs.T)
    total_var = eigenvals.sum()
    ratio = eigenvals / total_var if total_var > 0 else np.zeros_like(eigenvals)
    return {
        "mean_": mean.astype(np.float64),
        "components_": vt,
        "explained_variance_": eigenvals,
        "explained_variance_ratio_": ratio,
    }


def nan_pca_transform(
    X: np.ndarray, mean: np.ndarray, components: np.ndarray
) -> np.ndarray:
    """EM-style per-sample projection with observed-coordinate masking
    (reference pca.py:566-608)."""
    is_valid = ~np.isnan(X)
    Xc = X - mean
    Xc[~is_valid] = 0.0
    W = components.T  # (D, n_comp)
    out = np.zeros((X.shape[0], components.shape[0]))
    for i in range(X.shape[0]):
        if is_valid[i].sum() == 0:
            continue
        try:
            cov_mat = np.diag(1.0 * is_valid[i])
            B = np.linalg.inv(W.T @ cov_mat @ W)
            out[i] = B @ W.T @ cov_mat @ Xc[i]
        except Exception:
            out[i] = 0.0
    return out


class EmpiricalEpsilon:
    """Percentile of a loss distribution (reference pca.py:611-636)."""

    def __init__(self, percentile: float) -> None:
        self.percentile = percentile

    def __call__(self, loss: np.ndarray) -> float:
        return float(np.nanpercentile(np.asarray(loss).flatten(), self.percentile))


class ComponentChooser:
    """Select component count by int or variance fraction
    (reference pca.py:639-738)."""

    def __init__(self, explained_variance_ratio: np.ndarray, components_to_keep) -> None:
        self.evr = np.asarray(explained_variance_ratio)
        self.components_to_keep = components_to_keep
        if isinstance(components_to_keep, int):
            if components_to_keep > len(self.evr):
                raise ValueError(
                    f"components_to_keep was set to {components_to_keep}, exceeding "
                    f"the maximum value of {len(self.evr)} observation dims"
                )
        elif isinstance(components_to_keep, float):
            if not 0.0 <= components_to_keep <= 1.0:
                raise ValueError(
                    f"components_to_keep was set to {components_to_keep} while it "
                    "has to be between 0.0 and 1.0"
                )

    def __call__(self) -> int:
        if isinstance(self.components_to_keep, int):
            return self.components_to_keep
        if isinstance(self.components_to_keep, float):
            if self.components_to_keep == 1.0:
                return len(self.evr)
            cumsum = np.cumsum(self.evr)
            return int(np.where(cumsum >= self.components_to_keep)[0][0]) + 1
        raise TypeError(
            f"components_to_keep must be int or float, got {type(self.components_to_keep)}"
        )


def format_multiview_data_for_pca(
    data_arr: np.ndarray, mirrored_column_matches: list
) -> np.ndarray:
    """(batch, K, 2) -> (batch * K_sel, 2 * n_views): one row per keypoint
    across views (reference pca.py:759-792)."""
    n_views = len(mirrored_column_matches)
    n_keypoints = len(mirrored_column_matches[0])
    views = []
    for view in range(n_views):
        assert len(mirrored_column_matches[view]) == n_keypoints
        sel = data_arr[:, np.array(mirrored_column_matches[view]), :]
        views.append(sel.transpose(2, 0, 1).reshape(2, -1))
    return np.concatenate(views, axis=0).T


class KeypointPCA:
    """Fit PCA on training keypoints; expose the loss-time torch functions
    (reference pca.py:30-328)."""

    def __init__(
        self,
        loss_type: str,
        data_module: Any,
        components_to_keep: int | float | None = 0.99,
        empirical_epsilon_percentile: float = 99.0,
        mirrored_column_matches: list | None = None,
        columns_for_singleview_pca: list | None = None,
        centering_method: str | None = None,
    ) -> None:
        assert loss_type in ("pca_singleview", "pca_multiview")
        self.loss_type = loss_type
        self.data_module = data_module
        self.components_to_keep = components_to_keep
        self.empirical_epsilon_percentile = empirical_epsilon_percentile
        if mirrored_column_matches is not None and isinstance(
            mirrored_column_matches[0], int
        ):
            # true-multiview: expand flat per-view indices
            # (reference pca.py:72-84)
            dataset = data_module.dataset
            view_names = getattr(dataset, "view_names", None)
            if view_names is None:
                raise ValueError(
                    "cfg.data.mirrored_column_matches must contain a list of indices "
                    "for each mirrored view"
                )
            num_views = len(view_names)
            num_keypoints = dataset.num_keypoints // num_views
            mirrored_column_matches = [
                (v * num_keypoints + np.array(mirrored_column_matches, dtype=int)).tolist()
                for v in range(num_views)
            ]
        self.mirrored_column_matches = mirrored_column_matches
        self.columns_for_singleview_pca = columns_for_singleview_pca
        self.centering_method = centering_method
        self.parameters: dict[str, Any] = {}
        self.pca_object: dict[str, np.ndarray] | None = None
        self._device_parameters: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    # -- data extraction -----------------------------------------------------------

    def _get_data(self) -> None:
        """Pull all train-split keypoints through the resize-only path
        (reference DataExtractor, extractor.py:21-126)."""
        dataset = self.data_module.dataset
        idxs = self.data_module.train_dataset.indices
        rows = [dataset.keypoints_resized(int(i)).reshape(-1) for i in idxs]
        self.data_arr = np.stack(rows).astype(np.float64)

    # -- formatting --------------------------------------------------------------

    def _format_data(self, data_arr: np.ndarray) -> np.ndarray:
        data_arr = np.asarray(data_arr)
        if self.loss_type == "pca_multiview":
            kp = data_arr.reshape(data_arr.shape[0], -1, 2)
            return format_multiview_data_for_pca(kp, self.mirrored_column_matches)
        kp = data_arr.reshape(data_arr.shape[0], -1, 2)
        if self.columns_for_singleview_pca is not None:
            kp = kp[:, np.array(self.columns_for_singleview_pca), :]
        if self.centering_method is not None:
            if self.centering_method == "mean":
                center = np.mean(kp, axis=1, keepdims=True)
            elif self.centering_method == "median":
                center = np.quantile(kp, 0.5, axis=1, keepdims=True)
            else:
                raise NotImplementedError(
                    f"centering_method: {self.centering_method}"
                )
            kp = kp - center
        return kp.reshape(kp.shape[0], -1)

    def format_data_torch(self, data_arr: torch.Tensor) -> torch.Tensor:
        """Torch mirror of ``_format_data`` for the loss: ``(B, 2K)`` flat
        keypoints -> the rows the PCA was fitted on."""
        kp = data_arr.reshape(data_arr.shape[0], -1, 2)
        if self.loss_type == "pca_multiview":
            views = []
            for columns in self.mirrored_column_matches:
                sel = kp[:, torch.as_tensor(columns, device=kp.device), :]  # (B, K_sel, 2)
                views.append(sel.permute(2, 0, 1).reshape(2, -1))
            return torch.cat(views, dim=0).T
        if self.columns_for_singleview_pca is not None:
            kp = kp[:, torch.as_tensor(self.columns_for_singleview_pca, device=kp.device), :]
        if self.centering_method is not None:
            if self.centering_method == "mean":
                center = kp.mean(dim=1, keepdim=True)
            elif self.centering_method == "median":
                center = torch.quantile(kp, 0.5, dim=1, keepdim=True)
            else:
                raise NotImplementedError(f"centering_method: {self.centering_method}")
            kp = kp - center
        return kp.reshape(kp.shape[0], -1)

    # -- fit ---------------------------------------------------------------------

    def _check_data(self) -> None:
        if self.data_arr.shape[0] < self.data_arr.shape[1]:
            raise ValueError(
                f"cannot fit PCA with {self.data_arr.shape[0]} samples < "
                f"{self.data_arr.shape[1]} observation dimensions"
            )

    def _choose_n_components(self) -> None:
        if self.loss_type == "pca_multiview":
            self._n_components_kept = 3
            if self.components_to_keep != 3:
                logger.warning(
                    f"for {self.loss_type} loss, you specified "
                    f"{self.components_to_keep} components_to_keep, but we will "
                    f"instead keep {self._n_components_kept} components"
                )
        else:
            self._n_components_kept = ComponentChooser(
                self.pca_object["explained_variance_ratio_"], self.components_to_keep
            )()

    def __call__(self) -> None:
        self._get_data()
        self.data_arr = self._format_data(self.data_arr)
        self._check_data()
        self.pca_object = nan_pca_fit(self.data_arr)
        self._choose_n_components()

        evr = np.round(self.pca_object["explained_variance_ratio_"], 3)
        tev = np.round(np.sum(evr[: self._n_components_kept]), 3)
        logger.info(
            f"results of running PCA ({self.loss_type}) on keypoints: kept "
            f"{self._n_components_kept}/{len(evr)} components; explained "
            f"variance ratio {evr}; total explained {tev}"
        )

        kept = self.pca_object["components_"][: self._n_components_kept]
        discarded = self.pca_object["components_"][self._n_components_kept:]
        self.parameters = {
            "mean": self.pca_object["mean_"].astype(np.float32),
            "kept_eigenvectors": kept.astype(np.float32),
            "discarded_eigenvectors": discarded.astype(np.float32),
        }
        self._device_parameters = {}
        err = self.compute_reprojection_error()
        self.parameters["epsilon"] = EmpiricalEpsilon(
            self.empirical_epsilon_percentile
        )(err)

    # -- reprojection -------------------------------------------------------------

    def reproject(self, data_arr: np.ndarray | None = None) -> np.ndarray:
        """Project onto kept components and back (reference pca.py:266-294).

        NaN observations are handled by the masked EM-style transform.
        """
        if data_arr is None:
            data_arr = self.data_arr
        data_arr = np.asarray(data_arr, dtype=np.float64)
        mean = self.parameters["mean"].astype(np.float64)
        evecs = self.parameters["kept_eigenvectors"].astype(np.float64)
        if np.isnan(data_arr).any():
            low_d = nan_pca_transform(data_arr, mean, evecs)
        else:
            low_d = (data_arr - mean) @ evecs.T
        return (low_d @ evecs + mean).astype(np.float32)

    def compute_reprojection_error(
        self, data_arr: np.ndarray | None = None
    ) -> np.ndarray:
        """Per-keypoint L2 reprojection error (reference pca.py:296-309)."""
        if data_arr is None:
            data_arr = self.data_arr
        data_arr = np.asarray(data_arr, dtype=np.float32)
        reproj = self.reproject(data_arr)
        diff = data_arr - reproj
        diff = diff.reshape(diff.shape[0], -1, 2)
        return np.linalg.norm(diff, axis=2)

    def device_parameters(self, device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The fitted float32 mean ``(D,)`` and kept eigenvectors
        ``(n_kept, D)`` as tensors of ``dtype`` on ``device``, made once."""
        key = (torch.device(device), dtype)
        if key not in self._device_parameters:
            self._device_parameters[key] = tuple(
                torch.from_numpy(self.parameters[name]).to(device=device, dtype=dtype)
                for name in ("mean", "kept_eigenvectors")
            )
        return self._device_parameters[key]

    def reprojection_error_torch(self, data_arr: torch.Tensor) -> torch.Tensor:
        """Per-keypoint reprojection error of formatted rows ``(N, D)`` ->
        ``(N, D / 2)``, differentiable (no NaNs expected in network
        predictions)."""
        mean, evecs = self.device_parameters(data_arr.device, data_arr.dtype)
        low_d = (data_arr - mean) @ evecs.T
        reproj = low_d @ evecs + mean
        diff = (data_arr - reproj).reshape(data_arr.shape[0], -1, 2)
        return torch.sqrt((diff**2).sum(dim=2) + 1e-12)
