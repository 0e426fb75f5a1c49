"""Bin-pair verification (LFW / CFP-FP / AgeDB protocol; counterpart of
``lafs_cvpr2024_tpu/eval/verification.py``).

The protocol is the JAX package's numpy code, copied as it is (the JAX
module sits behind jax imports): pairs of embeddings, squared-L2 distance,
10 contiguous folds (sklearn ``KFold(shuffle=False)``), per fold the best
threshold on the train folds (sweep 0..4 step .01) scores the test fold.

What changes is where the images live: :func:`load_bin` decodes a ``.bin``
pickle's JPEGs with ``data/decode.py`` (nvJPEG into device memory on the
card, PIL on the CPU) into one (2, N, H, W, 3) uint8 tensor, original and
flipped, on the device, and :func:`perform_val` feeds its batches to the
embed function there. The port does not resize: a ``.bin`` whose images
are not ``image_size`` raises (the JAX loader resizes with PIL's bilinear
filter; ROADMAP.md §3 lists the inputs the port refuses).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.decode import decode_batch, jpeg_dims
from ..ops.augment_device import scale_uint8
from ..train.device import resolve


def kfold_indices(n: int, n_folds: int):
    """sklearn KFold(shuffle=False) semantics: first n % n_folds folds get
    one extra sample; test folds are contiguous."""
    sizes = np.full(n_folds, n // n_folds, dtype=int)
    sizes[: n % n_folds] += 1
    idx = np.arange(n)
    start = 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        yield train, test
        start += s


def calculate_accuracy(threshold, dist, actual_issame):
    """Reference ``verification.py:224-234``."""
    predict = np.less(dist, threshold)
    tp = np.sum(np.logical_and(predict, actual_issame))
    fp = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    tn = np.sum(np.logical_and(np.logical_not(predict), np.logical_not(actual_issame)))
    fn = np.sum(np.logical_and(np.logical_not(predict), actual_issame))
    tpr = 0 if (tp + fn == 0) else tp / (tp + fn)
    fpr = 0 if (fp + tn == 0) else fp / (fp + tn)
    acc = 0.0 if dist.size == 0 else (tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_roc(
    thresholds, embeddings1, embeddings2, actual_issame, nrof_folds=10
):
    """Reference ``verification.py:37-91``: squared-L2 pair distances, then
    the shared KFold threshold sweep (:func:`_roc_from_dist`)."""
    n = min(len(actual_issame), embeddings1.shape[0])
    diff = embeddings1 - embeddings2
    dist = np.sum(diff * diff, axis=1)
    return _roc_from_dist(
        dist[:n], np.asarray(actual_issame, dtype=bool)[:n],
        thresholds, nrof_folds,
    )


def calculate_val(
    thresholds, embeddings1, embeddings2, actual_issame, far_target, nrof_folds=10
):
    """VAL@FAR metric (reference ``verification.py:237-278``)."""
    n = min(len(actual_issame), embeddings1.shape[0])
    diff = embeddings1 - embeddings2
    dist = np.sum(diff * diff, axis=1)
    issame = np.asarray(actual_issame, dtype=bool)
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    for fold, (train, test) in enumerate(kfold_indices(n, nrof_folds)):
        far_train = np.array(
            [_val_far(t, dist[train], issame[train])[1] for t in thresholds]
        )
        if np.max(far_train) >= far_target:
            threshold = np.interp(far_target, far_train, thresholds)
        else:
            threshold = 0.0
        val[fold], far[fold] = _val_far(threshold, dist[test], issame[test])
    return val.mean(), val.std(), far.mean()


def _val_far(threshold, dist, actual_issame):
    predict = np.less(dist, threshold)
    ta = np.sum(np.logical_and(predict, actual_issame))
    fa = np.sum(np.logical_and(predict, np.logical_not(actual_issame)))
    n_same = max(np.sum(actual_issame), 1)
    n_diff = max(np.sum(np.logical_not(actual_issame)), 1)
    return ta / n_same, fa / n_diff


def evaluate(embeddings, actual_issame, nrof_folds=10):
    """Reference ``verification.py:292-302``: embeddings interleaved
    (pair[i] = rows 2i, 2i+1)."""
    thresholds = np.arange(0, 4, 0.01)
    return calculate_roc(
        thresholds, embeddings[0::2], embeddings[1::2], actual_issame, nrof_folds
    )


def _roc_from_dist(dist, actual_issame, thresholds, nrof_folds=10):
    """KFold threshold-sweep over a precomputed distance vector."""
    n = len(dist)
    issame = np.asarray(actual_issame, dtype=bool)
    n_thr = len(thresholds)
    tprs = np.zeros((nrof_folds, n_thr))
    fprs = np.zeros((nrof_folds, n_thr))
    accuracy = np.zeros(nrof_folds)
    best_thresholds = np.zeros(nrof_folds)
    pred = dist[None, :] < np.asarray(thresholds)[:, None]
    for fold, (train, test) in enumerate(kfold_indices(n, nrof_folds)):
        acc_train = (pred[:, train] == issame[None, train]).mean(axis=1)
        best = int(np.argmax(acc_train))
        best_thresholds[fold] = thresholds[best]
        for ti in range(n_thr):
            tprs[fold, ti], fprs[fold, ti], _ = calculate_accuracy(
                thresholds[ti], dist[test], issame[test]
            )
        _, _, accuracy[fold] = calculate_accuracy(
            thresholds[best], dist[test], issame[test]
        )
    return tprs.mean(0), fprs.mean(0), accuracy, best_thresholds


def evaluate_token(embeddings, actual_issame, nrof_folds=10):
    """Cosine-distance variant (reference ``calculate_roc_token``,
    ``verification.py:94-162``: scipy ``distance.cosine`` per pair)."""
    e1 = embeddings[0::2]
    e2 = embeddings[1::2]
    n1 = np.maximum(np.linalg.norm(e1, axis=1), 1e-12)
    n2 = np.maximum(np.linalg.norm(e2, axis=1), 1e-12)
    dist = 1.0 - np.sum(e1 * e2, axis=1) / (n1 * n2)
    return _roc_from_dist(dist, actual_issame, np.arange(0, 4, 0.01), nrof_folds)


def evaluate_two(embeddings_a, embeddings_b, actual_issame, nrof_folds=10):
    """Two-model score fusion (reference ``calculate_roc_two`` /
    ``evaluate_two``, ``verification.py:164-221,304-316``): per-pair squared-
    L2 distances of the two models are summed before the threshold sweep."""

    def sqdist(e):
        d = e[0::2] - e[1::2]
        return np.sum(d * d, axis=1)

    dist = sqdist(embeddings_a) + sqdist(embeddings_b)
    return _roc_from_dist(dist, actual_issame, np.arange(0, 8, 0.01), nrof_folds)


def _jpeg_bytes(raw) -> bytes:
    """A ``.bin`` entry as bytes: pickles hold bytes, or arrays of them."""
    if isinstance(raw, (bytes, bytearray)):
        return bytes(raw)
    return raw.tobytes() if hasattr(raw, "tobytes") else bytes(raw)


def load_bin(path: str, image_size=(112, 112), device="cuda",
             chunk: int = 512):
    """Load a verification ``.bin`` (pickle of (jpeg list, issame list))
    into one (2, N, H, W, 3) uint8 tensor on ``device``, original then
    horizontally flipped, and the (N/2,) bool ``issame`` (reference
    ``util/utils.py:27-47``). Decodes ``chunk`` images per call; raises for
    an image that is not ``image_size`` (H, W)."""
    device = resolve(device)
    with open(path, "rb") as f:
        bins, issame_list = pickle.load(f, encoding="bytes")
    n = len(issame_list) * 2
    jpegs = [_jpeg_bytes(bins[i]) for i in range(n)]
    size = tuple(image_size)
    for i, b in enumerate(jpegs):
        if jpeg_dims(b, device) != size:
            raise ValueError(
                f"{path}: image {i} is {jpeg_dims(b, device)}, not {size}; "
                "the port does not resize (ROADMAP.md §3)")
    data = torch.empty((2, n, *size, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        data[0, s : s + chunk] = decode_batch(jpegs[s : s + chunk], device)
    data[1] = data[0].flip(2)  # the width axis of NHWC
    return data, np.asarray(issame_list, dtype=bool)


def get_val_data(data_path: str, targets: Sequence[str], device="cuda"):
    """Reference ``util/utils.py:59-65``: ``[(name, data, issame)]``."""
    return [(t, *load_bin(os.path.join(data_path, t + ".bin"), device=device))
            for t in targets]


@dataclass
class VerificationResult:
    accuracy: float
    accuracy_std: float
    xnorm: float
    best_threshold: float
    tpr: np.ndarray
    fpr: np.ndarray


def perform_val(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    data: torch.Tensor,
    issame: np.ndarray,
    batch_size: int = 512,
    nrof_folds: int = 10,
    input_scale: str = "half",
    device_scale: bool = False,
) -> VerificationResult:
    """In-training verification (reference ``util/utils.py:292-397``).

    Args:
      embed_fn: (B, H, W, 3) batch on ``data``'s device → (B, D) embeddings
        (a tensor, moved to numpy here, or an array).
      data: (2, N, H, W, 3) uint8 (orig + flipped from :func:`load_bin`).
      issame: (N/2,) bool.
      input_scale: 'half' = x/255 - 0.5 (the reference eval convention)
        or 'unit' = x/255*2-1 (train convention), applied here on the
        device unless ``device_scale``.
      device_scale: pass the RAW uint8 batch to ``embed_fn``, which scales
        it itself (``make_embed_fn(..., input_scale=...)``).

    Flip fusion: embeddings of orig and flipped are ADDED then normalized.
    """
    data = torch.as_tensor(data)
    n = data.shape[1]
    embeddings_list = []
    for flip in range(2):
        chunks = []
        for start in range(0, n, batch_size):
            batch = data[flip, start : start + batch_size]
            if not device_scale:
                batch = scale_uint8(batch, input_scale)
            emb = embed_fn(batch)
            if isinstance(emb, torch.Tensor):
                emb = emb.detach().float().cpu().numpy()
            chunks.append(np.asarray(emb))
        embeddings_list.append(np.concatenate(chunks, axis=0))

    xnorm = float(
        np.mean([np.linalg.norm(e, axis=1).mean() for e in embeddings_list])
    )
    embeddings = embeddings_list[0] + embeddings_list[1]
    embeddings = embeddings / np.maximum(
        np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12
    )
    tpr, fpr, accuracy, best_thresholds = evaluate(embeddings, issame, nrof_folds)
    return VerificationResult(
        accuracy=float(accuracy.mean()),
        accuracy_std=float(accuracy.std()),
        xnorm=xnorm,
        best_threshold=float(best_thresholds.mean()),
        tpr=tpr,
        fpr=fpr,
    )
