"""IJB-B / IJB-C 1:1 template verification protocol (counterpart of
``lafs_cvpr2024_tpu/eval/ijb.py``, whose numpy code this module copies as
it is: the JAX module is reached only through jax imports).

Reference: ``IJB_evaluation.py`` end-to-end —
  5-pt landmark → similarity-transform alignment to 112×112 (:198-230),
  flip-test double embedding (:222-246), flip fusion by addition (:731-738),
  norm-score / detector-score weighting (:740-749), media-then-template
  aggregation (:501-535), batched cosine pair scoring (:541-567),
  ROC → TPR@FPR ∈ {1e-6..1e-1} table (:784-827).

numpy replaces sklearn/skimage: the similarity transform is the Umeyama
algorithm; the ROC is a direct sort-based curve. The embedding sweep is the
caller's (``cli/evaluate_ijb.py``); the card aligns a batch with
``ops/warp.py::warp_affine_batch``, which :func:`warp_affine` is the
host reference of.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# ArcFace 112×112 5-point template (reference IJB_evaluation.py:144-151,
# x += 8 applied)
ARCFACE_SRC = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama(src: np.ndarray, dst: np.ndarray, estimate_scale: bool = True) -> np.ndarray:
    """Least-squares similarity transform (Umeyama 1991), the algorithm behind
    ``skimage.transform.SimilarityTransform.estimate``. Returns 3×3 matrix."""
    num, dim = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_d = src - src_mean
    dst_d = dst - dst_mean
    A = dst_d.T @ src_d / num
    d = np.ones(dim)
    if np.linalg.det(A) < 0:
        d[-1] = -1
    T = np.eye(dim + 1)
    U, S, V = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return T * np.nan
    elif rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(V) > 0:
            T[:dim, :dim] = U @ V
        else:
            s = d[-1]
            d[-1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ V
            d[-1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ V
    scale = (d * S).sum() / src_d.var(axis=0).sum() if estimate_scale else 1.0
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean)
    T[:dim, :dim] *= scale
    return T


def warp_affine(img: np.ndarray, M: np.ndarray, out_size: Tuple[int, int]) -> np.ndarray:
    """Bilinear inverse warp (cv2.warpAffine equivalent, borderValue=0).

    img: (H, W, C) uint8/float; M: 2×3 forward map src→dst; out_size (H, W).
    """
    oh, ow = out_size
    Mi = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    src_x = Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2]
    src_y = Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2]
    x0 = np.floor(src_x).astype(np.int32)
    y0 = np.floor(src_y).astype(np.int32)
    wx = src_x - x0
    wy = src_y - y0
    h, w = img.shape[:2]
    out = np.zeros((oh, ow, img.shape[2]), dtype=np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            weight = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            vals = np.zeros_like(out)
            vals[valid] = img[yi[valid], xi[valid]].astype(np.float32)
            out += vals * weight[..., None] * valid[..., None]
    return out.astype(img.dtype if np.issubdtype(img.dtype, np.integer) else np.float32)


def norm_crop(img: np.ndarray, landmark5: np.ndarray, image_size: int = 112) -> np.ndarray:
    """Align a face by its 5-pt landmarks to the ArcFace template
    (reference ``IJB_evaluation.py:198-230``)."""
    T = umeyama(landmark5.astype(np.float32), ARCFACE_SRC)
    return warp_affine(img, T[:2], (image_size, image_size))


def image2template_feature(
    img_feats: np.ndarray, templates: np.ndarray, medias: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Media-then-template aggregation (reference ``IJB_evaluation.py:501-535``):
    per template, frames of a video (same media id) are averaged first, then
    media features are SUMMED and the sum L2-normalized."""
    # one argsort groups rows by template (the reference's np.where-per-
    # template rescan is O(T·N) ≈ 1e10 comparisons on IJB-C; this is
    # O(N log N) with identical aggregation order-independence)
    order = np.argsort(templates, kind="stable")
    sorted_t = templates[order]
    unique_templates, starts = np.unique(sorted_t, return_index=True)
    bounds = np.append(starts, len(sorted_t))
    dim = img_feats.shape[1]
    out = np.zeros((len(unique_templates), dim))
    for i in range(len(unique_templates)):
        ind_t = order[bounds[i]:bounds[i + 1]]
        feats = img_feats[ind_t]
        face_medias = medias[ind_t]
        unique_medias, inv, counts = np.unique(
            face_medias, return_inverse=True, return_counts=True
        )
        # per-media mean via one bincount pass, then sum of media means
        sums = np.zeros((len(unique_medias), dim))
        np.add.at(sums, inv, feats)
        out[i] = np.sum(sums / counts[:, None], axis=0)
    norms = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out / norms, unique_templates


def pair_scores(
    template_norm_feats: np.ndarray,
    unique_templates: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    batch: int = 100000,
) -> np.ndarray:
    """Batched cosine scoring of verification pairs
    (reference ``IJB_evaluation.py:541-567``).

    The gather/dot runs through PREALLOCATED per-batch buffers
    (``np.take(..., out=)`` + ``einsum(..., out=)``): at IJB-C scale
    (15.6M pairs) the reference's fresh-temporary pattern spends most of
    its wall-clock first-touching ~130 GB of short-lived pages."""
    template2id = np.zeros(int(unique_templates.max()) + 1, dtype=int)
    template2id[unique_templates] = np.arange(len(unique_templates))
    n, dim = len(p1), template_norm_feats.shape[1]
    t = len(unique_templates)
    if t * t <= 64 * n:
        # dense pair list (IJB-C: 15.6M pairs over 23k templates): ONE BLAS
        # gram matmul + scalar lookups beats 2n row gathers by ~4× here
        gram = template_norm_feats @ template_norm_feats.T
        return gram[template2id[p1], template2id[p2]]
    score = np.zeros(n)
    f1 = np.empty((min(batch, n), dim), template_norm_feats.dtype)
    f2 = np.empty_like(f1)
    for s in range(0, n, batch):
        m = min(batch, n - s)
        np.take(template_norm_feats, template2id[p1[s : s + m]], axis=0, out=f1[:m])
        np.take(template_norm_feats, template2id[p2[s : s + m]], axis=0, out=f2[:m])
        np.einsum("ij,ij->i", f1[:m], f2[:m], out=score[s : s + m])
    return score


def roc_curve(scores: np.ndarray, labels: np.ndarray, drop_intermediate: bool = True):
    """sklearn.metrics.roc_curve equivalent, including its default
    ``drop_intermediate`` pruning of collinear points (the reference's
    TPR@FPR lookup runs on that pruned grid, ``IJB_evaluation.py:792``)."""
    order = np.argsort(-scores, kind="mergesort")
    scores = scores[order]
    labels = labels[order].astype(bool)
    tps = np.cumsum(labels)
    fps = np.cumsum(~labels)
    # keep last index of each distinct score
    distinct = np.where(np.diff(scores))[0]
    idx = np.r_[distinct, len(scores) - 1]
    tps, fps = tps[idx], fps[idx]
    if drop_intermediate and len(fps) > 2:
        keep = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        tps, fps = tps[keep], fps[keep]
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return np.r_[0.0, fpr], np.r_[0.0, tpr]


def tpr_at_fpr_table(
    scores: np.ndarray,
    labels: np.ndarray,
    fpr_targets: Sequence[float] = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1),
) -> Dict[float, float]:
    """TPR@FPR table (reference ``IJB_evaluation.py:784-827``: nearest
    FPR-grid point, matching its ``np.argmin(abs(fpr - target))``)."""
    fpr, tpr = roc_curve(scores, labels)
    out = {}
    for t in fpr_targets:
        _, idx = min((abs(f - t), i) for i, f in enumerate(fpr))
        out[t] = float(tpr[idx])
    return out


@dataclass
class IJBConfig:
    use_norm_score: bool = True     # "N": skip re-normalize, keep feat norm
    use_detector_score: bool = True  # "D": multiply by detector confidence
    use_flip_test: bool = True       # "F": fuse orig+flip by addition


def fuse_features(
    feats: np.ndarray, faceness_scores: Optional[np.ndarray], cfg: IJBConfig
) -> np.ndarray:
    """Flip fusion + score weighting (reference ``IJB_evaluation.py:725-749``).

    feats: (N, 2D) concatenated [orig | flip] embeddings.
    """
    d = feats.shape[1] // 2
    if cfg.use_flip_test:
        img_feats = feats[:, :d] + feats[:, d:]
    else:
        img_feats = feats[:, :d]
    if not cfg.use_norm_score:
        img_feats = img_feats / np.maximum(
            np.linalg.norm(img_feats, axis=1, keepdims=True), 1e-12
        )
    if cfg.use_detector_score and faceness_scores is not None:
        img_feats = img_feats * faceness_scores[:, None]
    return img_feats


def run_ijb_protocol(
    img_feats: np.ndarray,
    templates: np.ndarray,
    medias: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    pair_labels: np.ndarray,
    faceness_scores: Optional[np.ndarray] = None,
    cfg: IJBConfig = IJBConfig(),
) -> Dict[float, float]:
    """Full scoring half of the IJB pipeline, from per-image [orig|flip]
    features to the TPR@FPR table."""
    fused = fuse_features(img_feats, faceness_scores, cfg)
    template_feats, unique_templates = image2template_feature(fused, templates, medias)
    scores = pair_scores(template_feats, unique_templates, p1, p2)
    return tpr_at_fpr_table(scores, pair_labels)


def read_template_media_list(path: str):
    """Parse ``*_face_tid_mid.txt`` (reference ``IJB_evaluation.py:669-676``)."""
    rows = np.loadtxt(path, dtype=str)
    templates = rows[:, 1].astype(int)
    medias = rows[:, 2].astype(int)
    return templates, medias


def read_template_pair_list(path: str):
    """Parse ``*_template_pair_label.txt`` (``IJB_evaluation.py:678-688``)."""
    rows = np.loadtxt(path, dtype=str)
    return rows[:, 0].astype(int), rows[:, 1].astype(int), rows[:, 2].astype(int)
