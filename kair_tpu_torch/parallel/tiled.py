"""Tiled inference over the ranks of a mesh (counterpart of
``kair_tpu/parallel/tiled.py``): one rank a tile, each running the whole
network on its window.

* ``make_sharded_tiled_fn``: overlap bands. Every rank holds the input,
  slices its band of rows plus ``halo`` (clamped at the true image border:
  the window always lies inside the image, the reference's quadrant rule,
  utils_model.py:127-151), runs the net, keeps its own rows, and an
  all-gather assembles the output on every rank. Exact when ``halo``
  covers the net's receptive-field radius.
* ``make_grid_sharded_fn`` / ``make_grid_sharded_video_fn``: a
  (tileh, tilew) grid where each rank holds only its tile; 2·halo rows
  and columns come from the neighbours (``batch_isend_irecv``; zeros past
  the image, as JAX's ``ppermute`` gives), the clamped window is run and
  the rank's own region of the output returned.
* ``halo_exchange_rows``: disjoint row bands with ``halo`` rows from each
  neighbour, the edge ranks repeating their border row.

The windows are ``eval/video_test.clamped_window_starts``', the host loops'
(``test_clip_grid``). Images are NHWC, clips (B, D, H, W, C).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from kair_tpu_torch.eval.video_test import clamped_window_starts
from kair_tpu_torch.parallel.mesh import Mesh


def _exchange(x: torch.Tensor, ext: int, mesh: Mesh, axis: str, dim: int):
    """(from the previous rank: its last ``ext`` rows along ``dim``, from
    the next: its first ``ext``); None past either end of the axis."""
    n, i = mesh.shape[axis], mesh.index(axis)
    size = x.shape[dim]
    last = x.narrow(dim, size - ext, ext).contiguous()
    first = x.narrow(dim, 0, ext).contiguous()
    prev = torch.empty_like(last) if i > 0 else None
    nxt = torch.empty_like(first) if i < n - 1 else None
    ops = []
    if i > 0:
        peer = mesh.rank_at(**{axis: i - 1})
        ops += [dist.P2POp(dist.isend, first, peer),
                dist.P2POp(dist.irecv, prev, peer)]
    if i < n - 1:
        peer = mesh.rank_at(**{axis: i + 1})
        ops += [dist.P2POp(dist.isend, last, peer),
                dist.P2POp(dist.irecv, nxt, peer)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return prev, nxt


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh,
                       axis: str = "tile") -> torch.Tensor:
    """(N, Hs, W, C) → (N, Hs + 2·halo, W, C): the previous rank's bottom
    rows above, the next rank's top rows below; the edge ranks repeat
    their border row."""
    prev, nxt = _exchange(x, halo, mesh, axis, 1)
    top = prev if prev is not None else x[:, :1].expand(-1, halo, -1, -1)
    bot = nxt if nxt is not None else x[:, -1:].expand(-1, halo, -1, -1)
    return torch.cat([top, x, bot], dim=1)


def _extend_dim(x: torch.Tensor, ext: int, mesh: Mesh, axis: str, dim: int):
    """Append ``ext`` rows along ``dim`` from both neighbours on ``axis``;
    zeros past the image (the clamped window never reads them)."""
    prev, nxt = _exchange(x, ext, mesh, axis, dim)
    zeros = torch.zeros_like(x.narrow(dim, 0, ext))
    return torch.cat([zeros if prev is None else prev, x,
                      zeros if nxt is None else nxt], dim=dim)


def _grid_tile(x: torch.Tensor, fn: Callable, mesh: Mesh, halo: int, sf: int,
               axes: Tuple[str, str], hdim: int) -> torch.Tensor:
    """One rank's grid tile: exchange 2·halo along both axes (rows first,
    then columns of the row-extended slab, which carries the corners), run
    ``fn`` on the clamped window, keep the tile's own region."""
    th, tw = mesh.shape[axes[0]], mesh.shape[axes[1]]
    ih, iw = mesh.index(axes[0]), mesh.index(axes[1])
    hs, ws = x.shape[hdim], x.shape[hdim + 1]
    if 2 * halo > hs or 2 * halo > ws:
        raise ValueError("2*halo must fit one neighbour tile (single-hop "
                         "exchange)")
    ext = _extend_dim(x, 2 * halo, mesh, axes[0], hdim)
    ext = _extend_dim(ext, 2 * halo, mesh, axes[1], hdim + 1)
    hstarts, band_h = clamped_window_starts(hs * th, hs, halo)
    wstarts, band_w = clamped_window_starts(ws * tw, ws, halo)
    sh, sw = hstarts[ih], wstarts[iw]
    # the slab starts at (i·hs − 2·halo)
    win = ext.narrow(hdim, sh - (ih * hs - 2 * halo), band_h) \
        .narrow(hdim + 1, sw - (iw * ws - 2 * halo), band_w)
    y = fn(win)
    return y.narrow(hdim, (ih * hs - sh) * sf, hs * sf) \
        .narrow(hdim + 1, (iw * ws - sw) * sf, ws * sf)


def make_grid_sharded_fn(fn: Callable, mesh: Mesh, halo: int, sf: int = 1,
                         axes: Tuple[str, str] = ("tileh", "tilew")
                         ) -> Callable:
    """Exact 2-D tile-grid forward with a non-replicated input: each rank
    passes its (N, H/th, W/tw, C) tile (``grid_tile``) and gets its
    (N, H/th·sf, W/tw·sf, C') tile of the output. True image borders see
    the net's own padding; interior seams are exact when ``halo`` covers
    the receptive-field radius (for window attention keep tiles and halo
    multiples of the window). Needs 2·halo ≤ the tile."""
    return lambda x: _grid_tile(x, fn, mesh, halo, sf, axes, hdim=1)


def make_grid_sharded_video_fn(fn: Callable, mesh: Mesh, halo: int,
                               sf: int = 1,
                               axes: Tuple[str, str] = ("tileh", "tilew")
                               ) -> Callable:
    """``make_grid_sharded_fn`` for (B, D, H, W, C) clips: the whole video
    net on each rank's clamped window (the reference's host patch loop,
    model_vrt.py:158-223; nets that estimate flow see per-window flows,
    as with ``size_patch_testing``)."""
    return lambda x: _grid_tile(x, fn, mesh, halo, sf, axes, hdim=2)


def grid_tile(mesh: Mesh, x: torch.Tensor,
              axes: Tuple[str, str] = ("tileh", "tilew"), hdim: int = 1
              ) -> torch.Tensor:
    """This rank's tile of a whole image (hdim 1) or clip (hdim 2): what
    the grid-sharded forwards take."""
    th, tw = mesh.shape[axes[0]], mesh.shape[axes[1]]
    hs, ws = x.shape[hdim] // th, x.shape[hdim + 1] // tw
    return x.narrow(hdim, mesh.index(axes[0]) * hs, hs) \
        .narrow(hdim + 1, mesh.index(axes[1]) * ws, ws)


def make_sharded_tiled_fn(fn: Callable, mesh: Mesh, halo: int, sf: int = 1,
                          axis: str = "tile") -> Callable:
    """Exact overlap-band forward over the ``axis`` ranks: (N, H, W, C) →
    (N, H·sf, W·sf, C') on every rank; H must divide the axis."""
    n = mesh.shape[axis]

    def band_fn(x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        if h % n:
            raise ValueError(f"H {h} does not divide {n} tiles")
        hs = h // n
        i = mesh.index(axis)
        starts, band = clamped_window_starts(h, hs, halo)
        y = fn(x[:, starts[i]:starts[i] + band])
        mine = y[:, (i * hs - starts[i]) * sf:(i * hs - starts[i] + hs) * sf]
        if n == 1:
            return mine
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine.contiguous(), group=mesh.group(axis))
        return torch.cat(parts, dim=1)

    return band_fn
