"""
K-means spectral clustering (counterpart: pyshepseg_tpu/ops/kmeans.py).

Lloyd's algorithm whose assignment step is one product: for points X and
centres C, the per-point argmin of 0.5*|c|^2 - x.c equals that of the
squared Euclidean distance but avoids the float32 cancellation of
|x|^2 - 2x.c + |c|^2. The product runs in full float32, never TF32: at
16-bit imagery magnitudes (scores ~1e8) reduced precision exceeds the
inter-cluster score margins and makes Lloyd's diverge (see the JAX
package's _assign_scores). The per-cluster sums go through
segreduce.index_sum, whose float sums on the card are order-fixed: the
same points and initial centres give the same fit bit for bit on every
run, as the JAX package promises for a fixed init.

:class:`TorchKMeans` mimics the slice of sklearn's KMeans the reference
uses (``fit``, ``predict``, ``cluster_centers_``, ``n_clusters``,
``inertia_``); its state is numpy arrays. Random draws (k-means++) come
from a ``torch.Generator`` seeded from ``random_state``; they are not the
JAX package's draws, so tests share fitted centres through
:func:`kmeansFromReference` or use a fixed init.
"""

import contextlib
import threading

import numpy as np
import torch

from .constants import SEGNULLVAL, MINSEGID
from .segreduce import index_sum
from .. import _kernels


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = None


@contextlib.contextmanager
def _fp32_matmul():
    """Full-float32 products for the body: TF32 off, restored after.

    The flag is process-global and the tiled driver's worker threads
    enter this concurrently, so it is reference-counted: the first thread
    in saves the user's setting and turns TF32 off, the last one out
    restores it. No body runs with TF32 on while another is inside."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


def _half_sq_norms(centers):
    """0.5*|c|^2 per centre, summed band by band in a fixed order (the
    same rounding on every device)."""
    cc = centers[:, 0] * centers[:, 0]
    for b in range(1, centers.shape[1]):
        cc = cc + centers[:, b] * centers[:, b]
    return 0.5 * cc


def _assign_scores(x, centers):
    """(N, K) assignment scores 0.5*|c|^2 - x.c (see the module doc)."""
    with _fp32_matmul():
        xc = x @ centers.T
    return _half_sq_norms(centers)[None, :] - xc


def _assign(x, centers):
    """Labels + exact squared distance to the assigned centre."""
    labels = torch.argmin(_assign_scores(x, centers), dim=1)
    diff = x - centers[labels]
    return labels, (diff * diff).sum(dim=1)


def _lloyd(x, centers, tol_scaled, max_iter: int):
    """Lloyd's iterations to convergence. Returns (centers, inertia,
    n_iter). The loop decides on the host after each iteration."""
    from .sync import to_host

    k = centers.shape[0]
    c = centers
    it = 0
    had_empty = False
    shift = float("inf")
    while (shift > tol_scaled or had_empty) and it < max_iter:
        labels, mind = _assign(x, c)
        # order-fixed on the card: a fixed init gives the same fit every run
        sums = index_sum(k, labels, x)
        counts = index_sum(k, labels, torch.ones_like(mind))
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        # one host sync an iteration; while clusters are empty the loop
        # goes on whatever the shift, so the pre-repair shift suffices
        n_empty, shift = to_host(torch.stack([
            empty.sum().to(x.dtype), ((new_c - c) ** 2).sum()]))
        had_empty = n_empty > 0
        if had_empty:
            # Empty-cluster repair: the j-th empty cluster re-seeds at the
            # j-th farthest point from any centre (distinct points),
            # nudged per rank so equal-valued donors stay distinct.
            donor_idx = torch.topk(mind, min(k, mind.shape[0])).indices
            donors = x[donor_idx]
            j = torch.arange(donors.shape[0], dtype=x.dtype,
                             device=x.device)
            donors = donors + (1e-4 * j)[:, None]
            rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1,
                               max=donors.shape[0] - 1)
            new_c = torch.where(empty[:, None], donors[rank], new_c)
        c = new_c
        it += 1
    _, mind = _assign(x, c)
    return c, mind.sum(), it


def _kmeanspp_init(x, k: int, generator):
    """k-means++ seeding with draws from ``generator``."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator,
                          device=generator.device)
    centers = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first.to(x.device)[0]]
    mind = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        d = ((x - centers[i - 1]) ** 2).sum(dim=1)
        mind = torch.minimum(mind, d)
        total = mind.sum()
        probs = torch.where(total > 0, mind / torch.clamp(total, min=1e-30),
                            torch.full_like(mind, 1.0 / n))
        idx = torch.multinomial(probs.to(generator.device), 1,
                                generator=generator)
        centers[i] = x[idx.to(x.device)[0]]
    return centers


def null_scalar(img_null_val, img_dtype):
    """
    The null value cast to the image's NATIVE numpy dtype, as a Python
    number. A float32 round trip would alias large integers (|v| > 2^24)
    onto neighbouring values; an integer-to-integer cast wraps exactly as
    the image's own values do.
    """
    return np.asarray(img_null_val).astype(img_dtype).item()


def assign_clusters(img, centers, img_null_val, has_null: bool):
    """
    Per-pixel nearest-centre cluster IDs starting at 1 (int32 (H, W));
    pixels equal to the null value in any band become SEGNULLVAL.

    ``img`` is (nBands, H, W) in its native values (integer images widened
    losslessly, see segreduce.image_tensor): the null comparison runs on
    those, scoring casts to float32. Band-major product
    (K, B) @ (B, H*W); ties go to the lowest centre index.
    """
    nbands, h, w = img.shape
    x_bm = img.reshape(nbands, h * w).to(torch.float32)
    cc = _half_sq_norms(centers)
    with _fp32_matmul():
        scores = cc[:, None] - centers @ x_bm             # (K, H*W)
    clusters = (torch.argmin(scores, dim=0).to(torch.int32) +
                MINSEGID).reshape(h, w)
    if has_null:
        nullmask = (img == img_null_val).any(dim=0)
        clusters = torch.where(nullmask, SEGNULLVAL, clusters)
    return clusters


def predict_labels(x, centers):
    """Nearest-centre labels (int64) for points x (N, B)."""
    return torch.argmin(_assign_scores(x, centers), dim=1)


class TorchKMeans:
    """
    Counterpart of the JAX package's TPUKMeans: ``fit``, ``predict``,
    ``cluster_centers_``, ``n_clusters``, ``inertia_``, ``n_iter_``.
    Pickleable (state is numpy arrays). ``device`` is where fit and
    predict run.
    """

    def __init__(self, n_clusters=8, n_init=5, init="k-means++",
                 max_iter=300, tol=1e-4, random_state=0, device="cuda"):
        self.n_clusters = int(n_clusters)
        self.n_init = int(n_init)
        self.init = init
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = int(random_state)
        self.device = str(device)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.n_iter_ = None

    @classmethod
    def from_arrays(cls, cluster_centers, inertia=None, n_iter=None,
                    device="cuda"):
        """A fitted TorchKMeans from its centres (K, B)."""
        centers = np.asarray(cluster_centers, dtype=np.float32)
        km = cls(n_clusters=centers.shape[0], n_init=1, init=centers,
                 device=device)
        km.cluster_centers_ = centers.copy()
        km.inertia_ = None if inertia is None else float(inertia)
        km.n_iter_ = None if n_iter is None else int(n_iter)
        return km

    def fit(self, X):
        device = _kernels.torch_device(self.device)
        X_np = np.asarray(X, dtype=np.float32)
        x = torch.from_numpy(np.ascontiguousarray(X_np)).to(device)
        tol_scaled = float(np.float32(
            self.tol * float(np.mean(np.var(X_np, axis=0)))))
        k = self.n_clusters
        if isinstance(self.init, str) and self.init == "k-means++":
            gen = torch.Generator(device=device)
            gen.manual_seed(self.random_state)
            best = None
            for _ in range(self.n_init):
                c0 = _kmeanspp_init(x, k, gen)
                c, inertia, n_iter = _lloyd(x, c0, tol_scaled, self.max_iter)
                inertia = float(inertia)
                # first of tied minima, like np.argmin over the trials
                if best is None or inertia < best[1]:
                    best = (c, inertia, n_iter)
            c, inertia, n_iter = best
        else:
            c0 = torch.tensor(np.asarray(self.init, dtype=np.float32),
                              device=device)
            if c0.shape[0] != k:
                raise ValueError("init centres shape mismatch")
            c, inertia, n_iter = _lloyd(x, c0, tol_scaled, self.max_iter)
        self.cluster_centers_ = c.cpu().numpy()
        self.inertia_ = float(inertia)
        self.n_iter_ = int(n_iter)
        return self

    def predict(self, X, chunk=1 << 20):
        """Nearest-centre labels, chunked to bound device memory."""
        device = _kernels.torch_device(self.device)
        X = np.asarray(X, dtype=np.float32)
        centers = torch.tensor(self.cluster_centers_.astype(np.float32),
                               device=device)
        out = np.empty(X.shape[0], dtype=np.int32)
        for start in range(0, X.shape[0], chunk):
            xs = torch.from_numpy(
                np.ascontiguousarray(X[start:start + chunk])).to(device)
            out[start:start + xs.shape[0]] = predict_labels(
                xs, centers).cpu().numpy()
        return out


def kmeansFromReference(obj, device="cuda"):
    """
    A :class:`TorchKMeans` holding the centres of any fitted object with
    ``cluster_centers_`` (a fitted TPUKMeans, an sklearn KMeans, ...): how
    the same clustering is handed to both packages.
    """
    return TorchKMeans.from_arrays(
        obj.cluster_centers_, inertia=getattr(obj, "inertia_", None),
        n_iter=getattr(obj, "n_iter_", None), device=device)
