"""Plain PyTorch 2-nearest-neighbour matching: the benchmark's reference
for the match path.

For every A row, the smallest and second-smallest squared L2 distance over
the B rows, ties to the earlier B row, reported as the correctly rounded
float32 ``sqrt``; "no neighbour" is index 0 and +inf (VulkanSift's
Get2NearestNeighbors semantics). The dot products run in float64, where
u8 products and their sums are exact integers. ``bits`` below 8 keeps only
the top ``bits`` bits of every byte first: the benchmark's control.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def match_2nn(desc_a: np.ndarray, desc_b: np.ndarray, device="cpu",
              bits: int = 8, rows: int = 4096):
    """(idx_b1, idx_b2, dist_a_b1, dist_a_b2) arrays for every A row."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    a = torch.as_tensor(desc_a, device=device).to(torch.int64)
    b = torch.as_tensor(desc_b, device=device).to(torch.int64)
    if bits < 8:
        a, b = a >> (8 - bits), b >> (8 - bits)
    a, b = a.double(), b.double()
    b_sq = (b * b).sum(1).long()
    i1 = torch.zeros(na, dtype=torch.int64, device=device)
    i2 = torch.zeros_like(i1)
    d1 = torch.full((na,), -1, dtype=torch.int64, device=device)
    d2 = torch.full_like(d1, -1)
    col = torch.arange(nb, device=device)
    for r in range(0, na if nb else 0, rows):
        x = a[r:r + rows]
        d = (x * x).sum(1).long()[:, None] + b_sq[None, :] \
            - 2 * (x @ b.T).long()
        key = (d << 20) | col[None, :]
        top = torch.topk(key, min(2, nb), dim=1, largest=False).values
        d1[r:r + rows], i1[r:r + rows] = top[:, 0] >> 20, top[:, 0] & 0xFFFFF
        if nb > 1:
            d2[r:r + rows] = top[:, 1] >> 20
            i2[r:r + rows] = top[:, 1] & 0xFFFFF

    def dist(d):
        return torch.where(d < 0, torch.inf,
                           torch.sqrt(d.clamp(min=0).double())).float()
    return (i1.cpu().numpy(), i2.cpu().numpy(), dist(d1).cpu().numpy(),
            dist(d2).cpu().numpy())
