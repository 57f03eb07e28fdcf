"""The port's photon hash grid against the reference's and a brute force.

The grid is integer work over the photons' float cells, so the port's
must equal the reference's exactly: the 32-bit cell hash (negative cells
included, cast to uint32 as the reference casts them), the stable sort by
bucket (the order inside a bucket decides which photons a capped cell
keeps) and the bucket range table. The 27-cell fold must visit every
photon within the cell size once: its radius counts equal a brute force's
and the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.ops import hashgrid as jgrid
from mitsuba_nlvrl_tpu_torch.ops import hashgrid as pgrid

torch.set_num_threads(1)   # one intra-op thread a test worker


def _photons(seed, P=3000):
    """Photons crowded into a few cells (many a cell), some below the
    grid origin (negative cells), a fifth invalid."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 0.04, (P, 3)).astype(np.float32)
    pos[: P // 3] += np.float32(0.05)
    valid = rng.random(P) > 0.2
    return pos, valid


def test_hash_matches_reference():
    rng = np.random.default_rng(0)
    cells = rng.integers(-2**31, 2**31, (4096, 3), dtype=np.int64).astype(
        np.int32)
    cells[:8] = [[0, 0, 0], [-1, -1, -1], [1, 0, 0], [0, -1, 0],
                 [2**31 - 1] * 3, [-2**31] * 3, [5, -7, 9], [-3, 4, -5]]
    a = np.asarray(jgrid._hash_cell(jnp.asarray(cells))).astype(np.int64)
    b = pgrid._hash_cell(torch.as_tensor(cells)).numpy()
    assert (a == b).all()
    assert b.min() >= 0 and b.max() < 2**32


@pytest.mark.parametrize('seed', [0, 1])
def test_build_matches_reference(seed):
    pos, valid = _photons(seed)
    origin = np.zeros(3, np.float32)
    cell = np.float32(0.04)
    a = jgrid.build(jnp.asarray(pos), jnp.asarray(valid),
                    jnp.asarray(origin), cell)
    b = pgrid.build(torch.as_tensor(pos), torch.as_tensor(valid),
                    torch.as_tensor(origin), torch.tensor(cell))
    assert b.cell_ranges.dtype == b.order.dtype == torch.int32
    assert (np.asarray(a.cell_ranges) == b.cell_ranges.numpy()).all()
    assert (np.asarray(a.order) == b.order.numpy()).all()
    # crowded: some bucket holds more than the fold's 32-photon cap
    counts = b.cell_ranges[:, 1] - b.cell_ranges[:, 0]
    assert int(counts.max()) > 32
    assert int(counts.sum()) == int(valid.sum())
    assert (np.floor(pos / cell) < 0).any()


@pytest.mark.parametrize('seed', [0, 1])
def test_fold_neighbors_matches_bruteforce_and_reference(seed):
    rng = np.random.default_rng(seed)
    P, N, r = 600, 96, 0.15
    pts = (rng.random((P, 3)) - 0.3).astype(np.float32)
    valid = rng.random(P) > 0.2
    q = (rng.random((N, 3)) - 0.3).astype(np.float32)
    active = rng.random(N) > 0.1
    origin = np.full(3, -0.3, np.float32)

    def fold_p(acc, idx, ok):
        d2 = ((torch.as_tensor(pts)[idx] - torch.as_tensor(q)[:, None]) ** 2
              ).sum(-1)
        sel = ok & (d2 <= r * r) & torch.as_tensor(valid)[idx]
        return acc + sel.sum(dim=1)

    def fold_j(acc, idx, ok):
        d2 = jnp.sum((jnp.asarray(pts)[idx] - jnp.asarray(q)[:, None]) ** 2,
                     -1)
        sel = ok & (d2 <= r * r) & jnp.asarray(valid)[idx]
        return acc + sel.sum(axis=1)

    gp = pgrid.build(torch.as_tensor(pts), torch.as_tensor(valid),
                     torch.as_tensor(origin), torch.tensor(r))
    got = pgrid.fold_neighbors(gp, torch.as_tensor(q),
                               torch.as_tensor(active), fold_p,
                               torch.zeros(N, dtype=torch.int64),
                               max_per_cell=64).numpy()
    gj = jgrid.build(jnp.asarray(pts), jnp.asarray(valid),
                     jnp.asarray(origin), r)
    ref = np.asarray(jgrid.fold_neighbors(
        gj, jnp.asarray(q), jnp.asarray(active), fold_j,
        jnp.zeros(N, jnp.int32), max_per_cell=64))
    d2 = ((pts[None] - q[:, None]) ** 2).sum(-1)
    brute = ((d2 <= r * r) & valid[None, :]).sum(1) * active
    assert (got == brute).all() and (got == ref).all()
    assert brute.max() > 3


def test_empty_map_folds_nothing():
    g = pgrid.build(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool),
                    torch.zeros(3), torch.tensor(0.1))
    init = torch.ones(4)
    out = pgrid.fold_neighbors(g, torch.zeros((4, 3)),
                               torch.ones(4, dtype=torch.bool),
                               lambda acc, idx, ok: acc + 1, init)
    assert out is init
