"""The routes of the one-direction LSTM inference layer (``ops/lstm.py``) and
the geometry of its cluster-of-16 kernel (``csrc/lstm_c16.cu``), on the CPU:
which (B, H, directions, dtype) take "resident", "cluster16" or "streamed", the
kernel's shared memory within a block's, and its tiles covering the batch."""

import pytest
import torch

from chiron_tpu_torch.ops import lstm as tlstm
from chiron_tpu_torch.ops import lstm_grad as tlg

F32, BF16 = torch.float32, torch.bfloat16

# (B, H, dirs, dtype, clusters of 16 the card holds (for the geometry), route)
ROUTE_CASES = [
    # Bonito HAC's layer: one float32 direction at H = 384, B = 400
    (400, 384, 1, F32, 8, "cluster16"),
    (400, 384, 1, F32, 7, "cluster16"),
    # past one wave of 64-row tiles, and small batches
    (600, 384, 1, F32, 8, "cluster16"),
    (1000, 384, 1, F32, 7, "cluster16"),
    (64, 384, 1, F32, 8, "cluster16"),
    (1, 384, 1, F32, 8, "cluster16"),
    # the route's lower edge: where cluster_geometry first streams wh, by batch
    (400, 320, 1, F32, 8, "resident"),
    (400, 321, 1, F32, 8, "cluster16"),
    (64, 324, 1, F32, 8, "resident"),
    (64, 325, 1, F32, 8, "cluster16"),
    (1, 336, 1, F32, 8, "resident"),
    (1, 337, 1, F32, 8, "cluster16"),
    (400, 330, 1, F32, 7, "cluster16"),
    # unchanged: the resident widths, both directions, H past 384, bf16
    (400, 128, 1, F32, 8, "resident"),
    (400, 256, 1, F32, 8, "resident"),
    (400, 100, 2, F32, 8, "resident"),
    (400, 384, 2, F32, 8, "streamed"),
    (400, 385, 1, F32, 8, "streamed"),
    (400, 512, 1, F32, 8, "streamed"),
    (400, 512, 2, F32, 8, "streamed"),
    (400, 384, 1, BF16, 8, "streamed"),
    (64, 384, 1, BF16, 8, "streamed"),
]


@pytest.mark.parametrize("bsz,h_dim,dirs,dtype,clusters,want", ROUTE_CASES)
def test_route_and_cluster16_geometry(bsz, h_dim, dirs, dtype, clusters, want):
    assert tlstm.route(bsz, h_dim, dirs, dtype) == want
    # the other routes are the kernels' own geometry, as before the cluster-16 kernel
    geometry = tlg.cluster_geometry("infer", bsz, h_dim, dirs, xw_bytes=dtype.itemsize)
    resident = tlg.weights_resident("infer", h_dim, *geometry, xw_bytes=dtype.itemsize)
    assert resident == (want == "resident")
    if h_dim <= 320:
        assert want == "resident"
    if want != "cluster16":
        return
    assert h_dim <= tlstm.C16_MAX_HIDDEN == 16 * 24
    assert tlstm.C16_SMEM_BYTES <= tlg.MAX_SHARED_BYTES
    rows, grid = tlstm.c16_geometry(bsz, clusters)
    tiles = -(-bsz // rows)
    assert rows % 16 == 0 and 16 <= rows <= tlstm.C16_MAX_ROWS
    # the tiles cover the batch, the last one holds a row, and the grid walks them all
    assert tiles * rows >= bsz > (tiles - 1) * rows
    assert 1 <= grid <= clusters and grid == min(clusters, tiles)
    # one wave wherever the card's clusters hold the batch at 64 rows each
    if bsz <= clusters * tlstm.C16_MAX_ROWS:
        assert tiles <= clusters
