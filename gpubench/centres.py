"""
The benchmark's own k-means: ``numClusters`` float32 centres fitted in
set-up over a seeded subsample of the scene's segmentation bands, with a
fixed initialisation and a fixed number of Lloyd iterations. The pixel
values are integers, so the per-cluster sums are exact in float64 in any
order: the same seed gives the same centres on every run. The centres go
to the program through ``TorchKMeans.from_arrays`` and to the reference
as the same array.
"""

import torch


def fit_centres(img, band_index, nodata, k, subsample, iterations, seed):
    """(k, len(band_index)) float32 centres, as a numpy array, from the
    (nbands, H, W) integer scene tensor ``img``: ``subsample`` pixels
    drawn from the seed (pixels that are ``nodata`` in any band are
    skipped), initialised at the first ``k`` distinct of them."""
    dev = img.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 7919 + 13) & (2 ** 63 - 1))
    h, w = img.shape[1:]
    flat = torch.randint(0, h * w, (subsample,), generator=gen, device=dev)
    # uint16 tensors take no advanced indexing on the card: widen first
    pix = torch.stack([band.reshape(-1).to(torch.int32)[flat]
                       for band in img])
    valid = ~(pix == nodata).any(dim=0)
    x = pix[band_index].T[valid].to(torch.float64)
    uniq = torch.unique(x, dim=0)
    if uniq.shape[0] < k:
        raise ValueError("fewer than %d distinct pixels in the subsample"
                         % k)
    pick = torch.randperm(uniq.shape[0], generator=gen, device=dev)[:k]
    c = uniq[pick.sort().values]
    for _ in range(iterations):
        d = torch.cdist(x, c)
        labels = torch.argmin(d, dim=1)
        counts = torch.bincount(labels, minlength=k).to(torch.float64)
        sums = torch.zeros_like(c).index_add_(0, labels, x)
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1)[:, None], c)
    return c.to(torch.float32).cpu().numpy()
