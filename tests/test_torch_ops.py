"""Port parity: dense stencils, label propagation (kernel A's function),
cluster ops and the row gather (kernel B's function).

Inputs come from numpy with a fixed seed and go through the JAX function and
its port on the CPU, where the port's wrappers take their plain PyTorch
versions. Integer and bool outputs must match bit for bit; float sums are
held to float32 rounding (tolerance stated per test)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from khronos_tpu.ops import clusters as jc
from khronos_tpu.ops import dense as jd
from khronos_tpu.ops.pallas.propagate import propagate_labels_3d_pallas
from khronos_tpu_torch.ops import clusters as tc
from khronos_tpu_torch.ops import dense as td
from khronos_tpu_torch.ops import gather as tg
from khronos_tpu_torch.ops import propagate as tp

from test_torch_kernels_cuda import FAMILIES, ODD_ITERATIONS, ODD_SHAPES, expected_rounds, propagate_case

SHAPE = (20, 16, 12)


def _seeded(seed, shape=SHAPE, p_seed=0.03, p_grow=0.5):
    rng = np.random.default_rng(seed)
    seeds = rng.random(shape) < p_seed
    grow = (rng.random(shape) < p_grow) | seeds
    lin = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    return np.where(seeds, lin, -1).astype(np.int32), grow


class TestDense:
    @pytest.mark.parametrize(
        "name",
        ["max_pool3_int", "min_pool3_int", "max_pool3_float", "min_pool3_float",
         "all_pool3", "all_pool3_pad_true", "any_pool3", "dilate2"],
    )
    def test_stencils_bit_exact(self, name):
        rng = np.random.default_rng(1)
        xi = rng.integers(-50, 50, SHAPE).astype(np.int32)
        xf = rng.normal(size=SHAPE).astype(np.float32)
        m = rng.random(SHAPE) < 0.7
        cases = {
            "max_pool3_int": (lambda f, a: f.max_pool3(a), xi),
            "min_pool3_int": (lambda f, a: f.min_pool3(a), xi),
            "max_pool3_float": (lambda f, a: f.max_pool3(a), xf),
            "min_pool3_float": (lambda f, a: f.min_pool3(a), xf),
            "all_pool3": (lambda f, a: f.all_pool3(a), m),
            "all_pool3_pad_true": (lambda f, a: f.all_pool3(a, pad_value=True), m),
            "any_pool3": (lambda f, a: f.any_pool3(a), m),
            "dilate2": (lambda f, a: f.dilate(a, 2), rng.random(SHAPE) < 0.05),
        }
        fn, x = cases[name]
        want = np.asarray(fn(jd, jnp.asarray(x)))
        got = fn(td, torch.from_numpy(x)).numpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)

    @pytest.mark.parametrize("iterations", [0, 1, 5, 16])
    def test_propagate_matches_xla_and_pallas(self, iterations):
        lab, grow = _seeded(iterations)
        want = np.asarray(jd.propagate_labels_3d(jnp.asarray(lab), jnp.asarray(grow), iterations))
        pallas = np.asarray(propagate_labels_3d_pallas(jnp.asarray(lab), jnp.asarray(grow), iterations))
        before = tp.launches
        got = td.propagate_labels_3d(torch.from_numpy(lab), torch.from_numpy(grow), iterations).numpy()
        np.testing.assert_array_equal(want, got)
        np.testing.assert_array_equal(pallas, got)
        assert tp.launches == before  # CPU tensors take the plain version

    def test_propagate_wall_keeps_labels_apart(self):
        shape = (8, 8, 48)
        labels = np.full(shape, -1, np.int32)
        labels[1, 1, 1] = 100
        labels[6, 6, 40] = 200
        grow = np.ones(shape, bool)
        grow[:, 4, :] = False  # wall
        out = tp.propagate_labels_3d(torch.from_numpy(labels), torch.from_numpy(grow), 12).numpy()
        assert (out[:, :4, :][out[:, :4, :] >= 0] == 100).all()
        assert (out[:, 5:, :][out[:, 5:, :] >= 0] == 200).all()
        assert (out[:, 4, :] == -1).all()
        want = np.asarray(propagate_labels_3d_pallas(jnp.asarray(labels), jnp.asarray(grow), 12))
        np.testing.assert_array_equal(want, out)

    def test_propagate_rejects_bad_inputs(self):
        lab, grow = _seeded(3)
        with pytest.raises(TypeError):
            tp.propagate_labels_3d(torch.from_numpy(lab).long(), torch.from_numpy(grow), 2)
        with pytest.raises(ValueError):
            tp.propagate_labels_3d(torch.from_numpy(lab), torch.from_numpy(grow)[:, :, :5], 2)
        with pytest.raises(ValueError):
            tp.propagate_labels_3d_cuda(torch.from_numpy(lab), torch.from_numpy(grow), 2)

    @pytest.mark.parametrize("iterations", [1, 7, 20])
    def test_propagate_keyed_bit_exact(self, iterations):
        lab, grow = _seeded(10 + iterations, p_seed=0.1, p_grow=0.7)
        key = np.random.default_rng(iterations).integers(-1, 3, SHAPE).astype(np.int32)
        want = np.asarray(jd.propagate_labels_keyed_3d(
            jnp.asarray(lab), jnp.asarray(key), jnp.asarray(grow), iterations))
        got = td.propagate_labels_keyed_3d(
            torch.from_numpy(lab), torch.from_numpy(key), torch.from_numpy(grow), iterations).numpy()
        np.testing.assert_array_equal(want, got)


def _schedule_model(labels, grow, iterations, tile=tp.TILE, depth=tp.DEPTH, blocks=3, seed=0):
    """A model, in PyTorch on the CPU, of csrc/propagate.cu's schedule: (out,
    rounds run). Phase 0 marks the tiles holding a growable cell and writes
    the others as -1 into `out`; each step loads every marked tile plus a
    halo `depth` cells deep, masked as loaded, runs up to `depth` rounds on
    that region (the 3-wide max along z, y, then x, then the mask; the
    region's faces go wrong a cell deeper each round, and never reach the
    tile), writes the tile into the step's ping-pong buffer and
    notes which rounds changed a cell of it; the steps stop after one with a
    round that changed nothing. `out` and `tmp` start as garbage, as
    torch.empty leaves them."""
    X, Y, Z = labels.shape
    ny, nz = -(-Y // tile[1]), -(-Z // tile[2])
    n_tiles = -(-X // tile[0]) * ny * nz
    gen = torch.Generator().manual_seed(seed)
    out = torch.randint(-9, 99, labels.shape, generator=gen, dtype=torch.int32)
    tmp = torch.randint(-9, 99, labels.shape, generator=gen, dtype=torch.int32)

    def corner(t):
        return t // (nz * ny) * tile[0], t // nz % ny * tile[1], t % nz * tile[2]

    def cells(t):  # the tile's slices, clipped at the grid border
        return tuple(slice(o, min(o + n, s)) for o, n, s in zip(corner(t), tile, (X, Y, Z)))

    def pool(a, axis):  # 3-wide max along one axis; at the region's faces a cell stands in for its missing neighbour
        n = a.shape[axis]
        p = torch.cat([a.narrow(axis, 0, 1), a, a.narrow(axis, n - 1, 1)], axis)
        return torch.maximum(torch.maximum(p.narrow(axis, 0, n), p.narrow(axis, 1, n)), p.narrow(axis, 2, n))

    marked = []
    for t in range(n_tiles):
        sl = cells(t)
        if iterations == 0:
            out[sl] = torch.where(grow[sl], labels[sl], -1)
        elif not bool(grow[sl].any()):
            out[sl] = -1
        else:
            marked.append(t)
    if iterations == 0 or not marked:
        return out, 0
    steps = -(-iterations // depth)
    buf = [tmp, out] if (steps - 1) % 2 else [out, tmp]  # the last step writes out
    rounds = 0
    for step in range(steps):
        h = min(depth, iterations - step * depth)
        src = labels if step == 0 else buf[(step - 1) % 2]
        dst = buf[step % 2]
        bits = 0
        for b in range(blocks):  # each block its own tiles
            for t in marked[b::blocks]:
                region = torch.full([n + 2 * depth for n in tile], -1, dtype=torch.int32)
                m = torch.zeros(region.shape, dtype=torch.bool)
                lo = [o - depth for o in corner(t)]
                gs = tuple(slice(max(a, 0), min(a + r, n)) for a, r, n in zip(lo, region.shape, (X, Y, Z)))
                rs = tuple(slice(g.start - a, g.stop - a) for g, a in zip(gs, lo))
                region[rs] = torch.where(grow[gs], src[gs], -1)
                m[rs] = grow[gs]
                inner = tuple(slice(depth, depth + n) for n in tile)
                for r in range(h):
                    new = torch.where(m, pool(pool(pool(region, 2), 1), 0), -1)
                    bits |= int(bool((new[inner] != region[inner]).any())) << r
                    region = new
                sl = cells(t)
                dst[sl] = region[inner][tuple(slice(0, c.stop - c.start) for c in sl)]
        rounds += h
        if step == steps - 1:
            break
        if bits != (1 << h) - 1:  # a round changed nothing: the fixpoint
            if dst is not out:
                for t in marked:
                    out[cells(t)] = dst[cells(t)]
            break
    return out, rounds


class TestKernelSchedule:
    """csrc/propagate.cu cannot run on the CPU: its schedule is rehearsed
    here, bit for bit against the plain version and the JAX function."""

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("shape", ODD_SHAPES)
    def test_model_matches_plain_and_jax(self, shape, family):
        lab, grow = propagate_case(shape, family)
        for iterations in ODD_ITERATIONS:
            got, rounds = _schedule_model(lab, grow, iterations, seed=iterations)
            want = tp.propagate_labels_3d_plain(lab, grow, iterations)
            ref = np.asarray(jd.propagate_labels_3d(jnp.asarray(lab.numpy()), jnp.asarray(grow.numpy()), iterations))
            np.testing.assert_array_equal(want.numpy(), ref, err_msg=f"{shape} {family} {iterations}")
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{shape} {family} {iterations}")
            assert rounds == expected_rounds(lab, grow, iterations), (shape, family, iterations)

    @pytest.mark.parametrize("tile,depth", [((8, 8, 16), 2), ((3, 5, 7), 3), ((1, 1, 1), 1), ((4, 4, 8), 4)])
    def test_model_any_tile_shape_and_depth(self, tile, depth):
        """The schedule does not depend on the tile shape or the rounds per
        step (the kernel's are tp.TILE and tp.DEPTH): ragged tiles, tiles of
        one cell, halos deeper than the tile."""
        lab, grow = _seeded(4, shape=(13, 11, 9), p_seed=0.02, p_grow=0.6)
        lab, grow = torch.from_numpy(lab), torch.from_numpy(grow)
        for iterations in (1, depth - 1, depth, depth + 1, 9):
            got, rounds = _schedule_model(lab, grow, iterations, tile=tile, depth=depth, blocks=2)
            assert torch.equal(got, tp.propagate_labels_3d_plain(lab, grow, iterations)), (tile, iterations)
            assert rounds == expected_rounds(lab, grow, iterations, depth), (tile, depth, iterations)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_no_change_then_never_again(self, seed):
        """The early exit's ground: the rounds only raise labels, and once a
        round changes nothing, no later round changes anything."""
        lab, grow = _seeded(20 + seed, p_seed=0.01, p_grow=0.35)
        lab, grow = torch.from_numpy(lab), torch.from_numpy(grow)
        cur = torch.where(grow, lab, -1)
        settled = None
        for k in range(80):
            nxt = tp.propagate_labels_3d_plain(cur, grow, 1)
            assert bool((nxt >= cur).all())
            if settled is None and torch.equal(nxt, cur):
                settled = k
            if settled is not None:
                assert torch.equal(nxt, cur), (settled, k)
            cur = nxt
        assert settled is not None and settled > 0


def _raw_labels(seed, n_values):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((24, 32)) < 0.6, rng.integers(0, n_values, (24, 32)), -1).astype(np.int32)


class TestClusters:
    @pytest.mark.parametrize("n_values", [5, 60])  # below and above max_clusters
    def test_compact_labels_and_unique(self, n_values):
        raw = _raw_labels(n_values, n_values)
        np.testing.assert_array_equal(
            np.asarray(jc.unique_smallest(jnp.asarray(raw.reshape(-1)), 32)),
            tc.unique_smallest(torch.from_numpy(raw.reshape(-1)), 32).numpy(),
        )
        want = np.asarray(jc.compact_labels(jnp.asarray(raw), 32))
        got = tc.compact_labels(torch.from_numpy(raw), 32).numpy()
        np.testing.assert_array_equal(want, got)

    def test_stats_renumber_and_samples(self):
        rng = np.random.default_rng(4)
        compact = np.array(jc.compact_labels(jnp.asarray(_raw_labels(4, 60)), 32))  # writable copy
        pts = rng.normal(size=(24, 32, 3)).astype(np.float32)
        extra = rng.integers(0, 7, (24, 32)).astype(np.int32)
        want = jc.cluster_stats(jnp.asarray(compact), jnp.asarray(pts), extra=jnp.asarray(extra), max_clusters=32)
        got = tc.cluster_stats(torch.from_numpy(compact), torch.from_numpy(pts), extra=torch.from_numpy(extra), max_clusters=32)
        counts, sums, bmin, bmax, ex = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(counts, got[0].numpy())
        # sums: the same float32 terms added in another order
        np.testing.assert_allclose(sums, got[1].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(bmin, got[2].numpy())  # extremes are copies
        np.testing.assert_array_equal(bmax, got[3].numpy())
        np.testing.assert_array_equal(ex, got[4].numpy())
        keep = counts >= 5
        ia, oa = jc.filter_and_renumber(jnp.asarray(compact), jnp.asarray(keep))
        ib, ob = tc.filter_and_renumber(torch.from_numpy(compact), torch.from_numpy(keep))
        np.testing.assert_array_equal(np.asarray(ia), ib.numpy())
        np.testing.assert_array_equal(np.asarray(oa), ob.numpy())
        for k in (4, 64):
            sa, va = jc.cluster_point_samples(jnp.asarray(compact), jnp.asarray(pts), k, 32)
            sb, vb = tc.cluster_point_samples(torch.from_numpy(compact), torch.from_numpy(pts), k, 32)
            np.testing.assert_array_equal(np.asarray(sa), sb.numpy())
            np.testing.assert_array_equal(np.asarray(va), vb.numpy())

    def test_compaction_and_cumsums(self):
        rng = np.random.default_rng(5)
        mask = rng.random(500) < 0.3
        vals = rng.integers(0, 1000, (500, 4)).astype(np.int32)
        ints = rng.integers(0, 3, (300, 5)).astype(np.int32)
        for cap in (50, 400):
            np.testing.assert_array_equal(
                np.asarray(jc.compact_indices(jnp.asarray(mask), cap)),
                tc.compact_indices(torch.from_numpy(mask), cap).numpy())
            np.testing.assert_array_equal(
                np.asarray(jc.compact_rows(jnp.asarray(vals), jnp.asarray(mask), cap)),
                tc.compact_rows(torch.from_numpy(vals), torch.from_numpy(mask), cap).numpy())
        np.testing.assert_array_equal(
            np.asarray(jc.exclusive_cumsum_1d(jnp.asarray(mask))),
            tc.exclusive_cumsum_1d(torch.from_numpy(mask)).numpy())
        np.testing.assert_array_equal(
            np.asarray(jc.exclusive_cumsum_2d(jnp.asarray(ints))),
            tc.exclusive_cumsum_2d(torch.from_numpy(ints)).numpy())


class TestGather:
    def _payload(self, rows):
        rng = np.random.default_rng(6)
        img = rng.random((rows, 2)).astype(np.float32)
        words = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
        words[:16] = 0x7FC00001 + np.arange(16, dtype=np.uint32)  # NaN bit patterns
        words[16:32] = 0xFF800000 | np.arange(1, 17, dtype=np.uint32)
        img[:, 1] = words.view(np.float32)
        return img

    def test_matches_take_bit_exact(self):
        img = self._payload(300)
        idx = np.random.default_rng(7).integers(0, 300, 1000).astype(np.int32)
        idx[:32] = np.arange(32)  # the NaN-pattern rows
        want = np.asarray(jnp.take(jnp.asarray(img), jnp.asarray(idx), axis=0))
        before = tg.launches
        got = tg.gather_rows(torch.from_numpy(img), torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
        assert tg.launches == before

    def test_out_of_range_rows_clamp_like_jnp_indexing(self):
        img = self._payload(50)
        idx = np.array([-7, -1, 0, 49, 50, 1000], np.int32)
        want = np.asarray(jnp.asarray(img)[jnp.asarray(idx)])
        got = tg.gather_rows(torch.from_numpy(img), torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))

    def test_rejects_bad_inputs(self):
        img = torch.zeros((10, 2))
        with pytest.raises(TypeError):
            tg.gather_rows(img, torch.zeros(4, dtype=torch.int64))
        with pytest.raises(ValueError):
            tg.gather_rows(img.reshape(-1), torch.zeros(4, dtype=torch.int32))
        with pytest.raises(ValueError):
            tg.gather_rows_cuda(img, torch.zeros(4, dtype=torch.int32))
