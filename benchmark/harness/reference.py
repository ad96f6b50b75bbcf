"""The plain reference of one frame of the active window's step.

Written from the semantics the configuration states (the window's
projective TSDF, colour and label fusion, the tracking layer, free-space
motion detection grown in 3D, per-class 3D components) in plain PyTorch.
It imports nothing of the program, and works out again everything the
program derives from the frame: the vertex image, the voxel occupancy, the
motion seeds and regions, the components, the exclusion mask, and the
integrated volume.

`step` takes the volume before a frame (the program's, or `fresh_volume`
for a robot's first frame) and returns the volume after it with the frame's
dynamic and object id images and the statistics of each kept cluster that
the tracker is handed. `mesh_round` gives the triangles of one emission
round of the archived surface; `scroll` the volume moved by a recentring.
All float arithmetic runs in `dtype`:
float32 is the reference; bfloat16, the precision below it, is the control
that the check has to refuse. Integer work (labels, ids, counts) is exact
either way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

FIELDS = ("tsdf", "weight", "color", "label", "label_weight", "first_obs", "last_obs", "last_occupied",
          "ever_free", "archived", "cell_meshed")
MC = 32  # clusters a frame and kind that the window keeps
K_SAMPLES = 64  # points of a cluster handed to the tracker


def fresh_volume(shape, cam_pos, voxel: float, trunc: float, device) -> Dict[str, torch.Tensor]:
    """An empty volume whose grid is centred on the camera."""
    origin = np.floor(np.asarray(cam_pos) / voxel - np.asarray(shape) / 2.0).astype(np.int64)
    full = lambda v, dt=torch.float32: torch.full(tuple(shape), v, dtype=dt, device=device)  # noqa: E731
    return dict(origin=origin, tsdf=full(trunc), weight=full(0.0),
                color=torch.zeros(tuple(shape) + (3,), device=device), label=full(-1, torch.int32),
                label_weight=full(0.0), first_obs=full(float("inf")), last_obs=full(float("-inf")),
                last_occupied=full(float("-inf")), ever_free=full(False, torch.bool),
                archived=full(False, torch.bool), cell_meshed=full(False, torch.bool))


def _pool_max(x: torch.Tensor, pad) -> torch.Tensor:
    """3x3x3 max over an [X, Y, Z] int or bool grid, borders read `pad`."""
    xf = F.pad(x.to(torch.float64)[None, None], (1, 1, 1, 1, 1, 1), value=float(pad))
    return F.max_pool3d(xf, 3, stride=1)[0, 0]


def any3(m: torch.Tensor) -> torch.Tensor:
    return _pool_max(m, 0) > 0


def all3(m: torch.Tensor) -> torch.Tensor:
    return -_pool_max(-(m.to(torch.float64)), -0.0) > 0  # borders read False


def grow(labels: torch.Tensor, growable: torch.Tensor, rounds: int) -> torch.Tensor:
    """26-connected region growing: `rounds` rounds of the largest label
    among each growable voxel's neighbours."""
    lab = torch.where(growable, labels, -1)
    for _ in range(rounds):
        lab = torch.where(growable, _pool_max(lab, -1).to(torch.int32), -1)
    return lab


def grow_keyed(labels: torch.Tensor, key: torch.Tensor, growable: torch.Tensor, rounds: int) -> torch.Tensor:
    """6-connected region growing between voxels of equal key."""
    lab = torch.where(growable, labels, -1)
    for _ in range(rounds):
        best = lab.clone()
        for axis in range(3):
            n = lab.shape[axis]
            for lo, hi in ((slice(0, n - 1), slice(1, n)), (slice(1, n), slice(0, n - 1))):
                dst = [slice(None)] * 3
                src = [slice(None)] * 3
                dst[axis], src[axis] = lo, hi
                dst, src = tuple(dst), tuple(src)
                cand = torch.where(key[dst] == key[src], lab[src], -1)
                best[dst] = torch.maximum(best[dst], cand)
        lab = torch.where(growable, best, -1)
    return lab


def components(raw: torch.Tensor, min_px: int, max_px: int) -> torch.Tensor:
    """Pixel labels (-1 none) -> the id image: the MC smallest distinct
    labels kept, in ascending order, those with min_px to max_px pixels
    numbered 1, 2, ... in that order, every other pixel 0."""
    flat = raw.reshape(-1)
    uniq = torch.unique(flat[flat >= 0])[:MC]
    out = torch.zeros_like(flat)
    next_id = 1
    for u in uniq.tolist():
        hit = flat == u
        n = int(hit.sum())
        if min_px <= n <= max_px:
            out[hit] = next_id
            next_id += 1
    return out.view(raw.shape)


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c of float32 values with one rounding (the float32 product
    is exact in float64)."""
    return (a.double() * float(b) + c.double()).float()


def vertex_image(d: torch.Tensor, fx, fy, cx, cy, R, t, dtype) -> torch.Tensor:
    """World points [H, W, 3] of a depth image. In float32 the sums are
    rounded in a fixed order, the one the port states for its vertex
    image: a pixel's ray (u + 0.5 - cx) times the float32 reciprocal of
    fx, scaled by the depth; each world coordinate the product with the
    rotation's first column rounded, the other two fused in turn, then
    the translation added. Points near a voxel's face then fall in the same
    voxel on both sides; in another precision the sums are plain."""
    H, W = d.shape
    dev = d.device
    R, t = np.asarray(R, np.float32), np.asarray(t, np.float32)
    if dtype != torch.float32:
        u = torch.arange(W, device=dev, dtype=dtype) + 0.5
        v = torch.arange(H, device=dev, dtype=dtype) + 0.5
        xr = ((u - cx) / fx)[None, :].expand(H, W)
        yr = ((v - cy) / fy)[:, None].expand(H, W)
        pc = torch.stack([xr * d, yr * d, d], dim=-1)
        Rt = torch.from_numpy(R).to(dev, dtype)
        return pc @ Rt.T + torch.from_numpy(t).to(dev, dtype)
    u = np.arange(W, dtype=np.float32) + np.float32(0.5)
    v = np.arange(H, dtype=np.float32) + np.float32(0.5)
    xr = torch.from_numpy((u - np.float32(cx)) * (np.float32(1) / np.float32(fx))).to(dev)[None, :]
    yr = torch.from_numpy((v - np.float32(cy)) * (np.float32(1) / np.float32(fy))).to(dev)[:, None]
    pc = (xr * d, yr * d, d)
    rows = []
    for i in range(3):
        acc = pc[0] * float(R[i, 0])
        for j in (1, 2):
            acc = fma32(pc[j], R[i, j], acc)
        rows.append(acc + float(t[i]))
    return torch.stack(rows, dim=-1)


def crop_box(shape, origin, cam_pos, sensor, voxel: float, trunc: float):
    """The camera-centred box (start, size) that holds every voxel within
    range of the camera, plus a one-voxel stencil margin, rounded up to 8."""
    need = int(np.ceil(2.0 * (sensor["max_range"] + trunc) / voxel)) + 4
    need = (need + 7) // 8 * 8
    size = (min(shape[0], need), min(shape[1], need), shape[2])
    cam_vox = np.floor(np.asarray(cam_pos, np.float32) / np.float32(voxel)).astype(np.int64) - origin
    start = np.clip(cam_vox - np.asarray(size) // 2, 0, np.asarray(shape) - np.asarray(size))
    return tuple(int(s) for s in start), size


def step(pre: Dict, depth, color, labels, R, t, t_now: float, cfg: dict, dtype=torch.float32) -> Dict:
    """One frame of the window's step. pre: a volume dict (origin int[3],
    grids); depth [H, W], color [H, W, 3], labels [H, W] on the device; R,
    t the camera pose (float32 numpy). Returns the volume after the frame
    with "dynamic_image" and "object_image" [H, W] int32."""
    sensor, aw, ls = cfg["sensor"], cfg["active_window"], cfg["label_space"]
    vm = aw["volumetric_map"]
    voxel, trunc = float(vm["voxel_size"]), float(vm.get("truncation_distance", 0.2))
    max_w, wnd, buf = float(vm.get("max_weight", 100.0)), float(vm.get("temporal_window", 3.0)), float(
        vm.get("temporal_buffer", 0.5))
    occ_t = float(vm.get("tsdf_occupancy_threshold", -1.5))
    occ_thr = -occ_t * voxel if occ_t < 0 else occ_t
    md, od = aw["motion_detector"], aw["object_detector"]
    md_min, md_max = int(md.get("min_cluster_size", 500)), int(md.get("max_cluster_size", 100000))
    md_sep, md_range = int(md.get("min_separation_distance", 2)), float(md.get("max_range", 5.0))
    md_rounds, md_min_z = int(md.get("grow_iterations", 16)), float(md.get("min_z", -1.0e9))
    od_min, od_rounds = int(od.get("min_cluster_size", 50)), int(od.get("grow_iterations", 20))
    s = int(aw.get("detection_stride", 1))
    dev = depth.device
    dt = dtype
    Rt = torch.from_numpy(np.asarray(R, np.float32)).to(dev, torch.float64).to(dt)
    tt = torch.from_numpy(np.asarray(t, np.float32)).to(dev, torch.float64).to(dt)
    shape = tuple(pre["tsdf"].shape)
    origin = np.asarray(pre["origin"], np.int64)
    st, size = crop_box(shape, origin, t, sensor, voxel, trunc)
    box = tuple(slice(a, a + n) for a, n in zip(st, size))
    sub = {f: pre[f][box].clone().to(dt) if pre[f].is_floating_point() else pre[f][box].clone() for f in FIELDS}
    sorigin = origin + np.asarray(st)

    # ---- detection on the strided image
    H, W = depth.shape
    Hd, Wd = H // s, W // s
    fx, fy = sensor["fx"] / s, sensor["fy"] / s
    cx = sensor["cx"] / s + 0.5 * (s - 1) / s
    cy = sensor["cy"] / s + 0.5 * (s - 1) / s
    d_d = depth[::s, ::s].to(dt)
    lab_d = labels[::s, ::s].long()
    pw = vertex_image(d_d, fx, fy, cx, cy, R, t, dt)  # [Hd, Wd, 3]
    valid = (d_d > sensor["min_range"]) & (d_d <= min(sensor["max_range"], md_range))
    vox = torch.floor(pw / torch.full((), voxel, dtype=dt, device=dev)).long() - torch.from_numpy(sorigin).to(dev)
    in_grid = valid & (vox >= 0).all(-1) & (vox < torch.tensor(size, device=dev)).all(-1)
    lin = (vox[..., 0] * size[1] + vox[..., 1]) * size[2] + vox[..., 2]
    lin = torch.where(in_grid, lin, 0)
    n = size[0] * size[1] * size[2]
    obj_lut = torch.zeros(ls["num_classes"] + 1, dtype=torch.bool, device=dev)
    obj_lut[list(ls["object_labels"])] = True
    pix_class = torch.where((lab_d >= 0) & obj_lut[lab_d.clamp(0, ls["num_classes"])], lab_d, -1)

    scan = torch.zeros(n, dtype=torch.bool, device=dev)
    scan[lin[in_grid]] = True
    scan = scan.view(size)
    vclass = torch.full((n,), -1, dtype=torch.long, device=dev)
    vclass.scatter_reduce_(0, lin[in_grid], pix_class[in_grid], "amax", include_self=True)
    vclass = vclass.view(size)
    ids = torch.arange(n, device=dev, dtype=torch.int32).view(size)

    # motion: seeds are occupied voxels that were free, grown in 3D
    seeds = scan & sub["ever_free"]
    growable = seeds
    for _ in range(max(0, md_sep - 1)):
        growable = any3(growable)
    mlab = grow(torch.where(seeds, ids, -1), growable, md_rounds)
    spread = _pool_max(mlab, -1).to(torch.int32)
    mlab = torch.where(scan, torch.where(mlab >= 0, mlab, spread), -1)
    pix_dyn = torch.where(in_grid, mlab.reshape(-1)[lin], -1)
    pix_dyn = torch.where(pw[..., 2] >= md_min_z, pix_dyn, -1)
    dyn_img = components(pix_dyn, max(1, round(md_min / (s * s))), max(1, round(md_max / (s * s))))

    # objects: components of voxels of one class
    keyed = grow_keyed(torch.where(vclass >= 0, ids, -1), vclass, vclass >= 0, od_rounds)
    ok = in_grid & (pix_class >= 0)
    hit_class = vclass.reshape(-1)[lin]
    pix_sem = torch.where(ok & (hit_class == pix_class), keyed.reshape(-1)[lin], -1)
    obj_img = components(pix_sem, max(1, round(od_min / (s * s))), 1 << 30)

    dyn_stats = cluster_stats(dyn_img, pw)
    obj_stats = cluster_stats(obj_img, pw, pix_class)

    dyn_full = dyn_img.repeat_interleave(s, 0).repeat_interleave(s, 1)
    obj_full = obj_img.repeat_interleave(s, 0).repeat_interleave(s, 1)

    # ---- integration at full resolution
    centers = [(torch.arange(size[a], device=dev, dtype=torch.float64) + float(sorigin[a]) + 0.5) * voxel
               for a in range(3)]
    cxw, cyw, czw = torch.meshgrid(*[c.to(dt) for c in centers], indexing="ij")
    dw = torch.stack([cxw - tt[0], cyw - tt[1], czw - tt[2]], dim=-1)
    pcv = dw @ Rt  # camera frame: R^T (p - t)
    z = pcv[..., 2]
    zs = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    uu = pcv[..., 0] / zs * sensor["fx"] + sensor["cx"]
    vv = pcv[..., 1] / zs * sensor["fy"] + sensor["cy"]
    in_img = (z > 1e-6) & (uu >= 0) & (uu <= W - 1) & (vv >= 0) & (vv <= H - 1)
    ui = torch.round(uu.float() - 0.5).clamp(0, W - 1).long()
    vi = torch.round(vv.float() - 0.5).clamp(0, H - 1).long()
    pix = vi * W + ui
    d = depth.reshape(-1)[pix].to(dt)
    rgb = (color.clamp(0.0, 1.0) * 255.0).floor().reshape(-1, 3)[pix].to(dt)
    plab = labels.reshape(-1).long().clamp(-1, 125)[pix]
    excl = (dyn_full > 0).reshape(-1)[pix]
    valid_v = in_img & (d > sensor["min_range"]) & (d <= sensor["max_range"])
    rng = torch.sqrt(pcv[..., 0] ** 2 + pcv[..., 1] ** 2 + z * z)
    sdf = (d - z) * (rng / zs)
    upd = valid_v & (sdf > -trunc) & (z <= sensor["max_range"]) & ~excl

    reset = upd & sub["archived"]
    inf = float("inf")
    for f, val in (("tsdf", trunc), ("weight", 0.0), ("label", -1), ("label_weight", 0.0), ("first_obs", inf),
                   ("last_obs", -inf), ("last_occupied", -inf)):
        sub[f] = torch.where(reset, torch.full_like(sub[f], val), sub[f])
    sub["color"] = torch.where(reset[..., None], 0.0, sub["color"])
    sub["ever_free"] = sub["ever_free"] & ~reset
    sub["archived"] = sub["archived"] & ~reset

    w = sub["weight"]
    w_new = torch.where(upd, (w + 1).clamp_max(max_w), w)
    near = upd & (sdf.abs() <= trunc)
    cw = w.clamp_max(20.0)
    tsdf_new = torch.where(upd, (sub["tsdf"] * w + sdf.clamp(-trunc, trunc)) / (w + 1), sub["tsdf"])
    color_new = torch.where(near[..., None], (sub["color"] * cw[..., None] + rgb / 255.0) / (cw[..., None] + 1),
                            sub["color"])
    has = near & (plab >= 0)
    same = has & (plab == sub["label"])
    diff = has & (plab != sub["label"])
    lw = sub["label_weight"]
    lw_new = torch.where(same, lw + 1, torch.where(diff, lw - 1, lw))
    take = diff & (lw_new <= 0)
    sub["label"] = torch.where(take, plab.to(torch.int32), sub["label"])
    sub["label_weight"] = torch.where(take, torch.ones_like(lw_new), lw_new)
    tn = torch.tensor(float(np.float32(t_now)), dtype=dt, device=dev)
    sub["first_obs"] = torch.where(upd, torch.minimum(sub["first_obs"], tn), sub["first_obs"])
    sub["last_obs"] = torch.where(upd, tn, sub["last_obs"])
    occ = (w_new > 0) & (tsdf_new < occ_thr)
    sub["last_occupied"] = torch.where(occ, tn, sub["last_occupied"])
    cand = (w_new > 0) & (sub["last_occupied"] + buf < tn)
    sub["tsdf"], sub["weight"], sub["color"] = tsdf_new, w_new, color_new
    sub["ever_free"] = sub["ever_free"] | all3(cand)
    sub["cell_meshed"] = sub["cell_meshed"] & ~any3(upd)

    post = {f: pre[f].clone() for f in FIELDS}
    for f in FIELDS:
        post[f][box] = sub[f].to(post[f].dtype)
    # archival: voxels unobserved for the temporal window leave it
    horizon = float(np.float32(t_now) - np.float32(wnd))
    inactive = (post["weight"] > 0) & (post["last_obs"] < horizon)
    post["archived"] = post["archived"] | inactive
    post["ever_free"] = post["ever_free"] & ~post["archived"]
    post["origin"] = origin
    post["dynamic_image"] = dyn_full.to(torch.int32)
    post["object_image"] = obj_full.to(torch.int32)
    post["updated"] = int(upd.sum())
    post["dyn_stats"], post["obj_stats"] = dyn_stats, obj_stats
    return post


def cluster_stats(ids: torch.Tensor, pw: torch.Tensor, pclass: torch.Tensor = None) -> Dict[int, Dict]:
    """What the tracker is handed of each kept cluster of an id image (ids
    1..N on the detection image, pw its world points): its pixel count,
    centroid, box, class (the largest pixel class, objects only) and K_SAMPLES
    of its points, evenly strided in raster order (sample s is the point of
    rank ceil(s * n / K_SAMPLES), all of them when n <= K_SAMPLES)."""
    flat = ids.reshape(-1)
    pts = pw.reshape(-1, 3).float()
    out = {}
    for k in torch.unique(flat[flat > 0]).tolist():
        sel = (flat == k).nonzero()[:, 0]
        p = pts[sel]
        n = int(sel.numel())
        ranks = torch.arange(n, device=p.device) if n <= K_SAMPLES else torch.tensor(
            [-(-j * n // K_SAMPLES) for j in range(K_SAMPLES)], device=p.device)
        row = dict(count=n, centroid=p.sum(0) / n, bmin=p.amin(0), bmax=p.amax(0), samples=p[ranks])
        if pclass is not None:
            row["category"] = int(pclass.reshape(-1)[sel].max())
        out[int(k)] = row
    return out


# marching tetrahedra: the cube's corners c0..c7, six tetrahedra around the c0-c6 diagonal
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def _tet_triangles(inside):
    """Triangles of one tetrahedron, as pairs of its local vertices (each
    pair the edge a vertex lies on, lower index first), for the tuple of
    four inside flags: the lone vertex's three edges, or for two inside
    (a < b) and two outside (x < y) the quad split along a-x to b-y."""
    ins = [i for i in range(4) if inside[i]]
    out = [i for i in range(4) if not inside[i]]
    e = lambda i, j: (min(i, j), max(i, j))  # noqa: E731
    if len(ins) in (1, 3):
        lone, rest = (ins[0], out) if len(ins) == 1 else (out[0], ins)
        return [[e(lone, r) for r in rest]]
    if len(ins) == 2:
        (a, b), (x, y) = ins, out
        return [[e(a, x), e(a, y), e(b, y)], [e(a, x), e(b, y), e(b, x)]]
    return []


def mesh_round(pre: Dict, cfg: dict, dtype=torch.float32) -> Dict:
    """One emission round of the archived surface from the volume `pre`:
    the cells whose eight corners are observed and archived, that the surface
    crosses and that are not meshed yet, in linear cell order, at most
    `mesh_max_cells` of them, cut where their triangles pass the round's
    capacity. Returns "rows" (one row a triangle: its three vertices
    quantised as the window's emission layout stores them, each with its
    label and 8-bit colour, the vertices in sorted order) and "meshed" (the
    cell flags after the round)."""
    vm = cfg["active_window"]["volumetric_map"]
    voxel = float(vm["voxel_size"])
    max_cells = int(cfg["active_window"].get("mesh_max_cells", 8192))
    capacity = max(min(6 * max_cells, 16384), 1024)
    tsdf, weight = pre["tsdf"], pre["weight"]
    X, Y, Z = tsdf.shape
    dev = tsdf.device
    views = lambda a: torch.stack([a[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]  # noqa: E731
                                   for dx, dy, dz in CORNERS])
    ins = views(tsdf) < 0
    want = ((views(weight) > 0).all(0) & ins.any(0) & (~ins).any(0) & views(pre["archived"]).all(0)
            & ~pre["cell_meshed"][:-1, :-1, :-1])
    cells = want.reshape(-1).nonzero()[:, 0][:max_cells]
    ci = cells // ((Y - 1) * (Z - 1))
    cj = (cells // (Z - 1)) % (Y - 1)
    ck = cells % (Z - 1)
    off = torch.tensor(CORNERS, device=dev)
    ii, jj, kk = (c[:, None] + off[None, :, a] for a, c in enumerate((ci, cj, ck)))  # [C, 8]
    sdf = tsdf[ii, jj, kk].to(dtype)
    col = pre["color"][ii, jj, kk].to(dtype)
    lab = pre["label"][ii, jj, kk]
    origin = np.asarray(pre["origin"], np.int64)
    pos = torch.stack([((c.to(torch.float32) + float(origin[a]) + 0.5) * voxel).to(dtype)
                       for a, c in enumerate((ii, jj, kk))], dim=-1)  # [C, 8, 3]
    corner_in = (sdf < 0).cpu().numpy()
    base = [float(np.float32(o) * np.float32(voxel)) for o in origin]
    qscale = torch.full((), float(max(X, Y, Z)) * voxel / 65535.0, dtype=torch.float32, device=dev)
    tris_of = {}  # the triangles of a tetrahedron's inside flags
    per_cell, verts, meta = [], [], []
    for c in range(len(cells)):
        n = 0
        for tet in TETS:
            flags = tuple(bool(corner_in[c, v]) for v in tet)
            if flags not in tris_of:
                tris_of[flags] = _tet_triangles(flags)
            for tri in tris_of[flags]:
                n += 1
                for i, j in tri:
                    verts.append((c, tet[i], tet[j]))
        per_cell.append(n)
    counts = torch.tensor(per_cell, dtype=torch.int64)
    done = torch.cumsum(counts, 0) <= capacity
    n_tris = int(counts[done].sum())
    meshed = pre["cell_meshed"].clone()
    done_cells = cells[done.to(dev)]
    mf = meshed[:-1, :-1, :-1].clone()
    mf.view(-1)[done_cells] = True
    meshed[:-1, :-1, :-1] = mf
    if n_tris == 0:
        return dict(rows=np.zeros((0, 21), np.int64), meshed=meshed, cells=int(done.sum()))
    v = torch.tensor(verts[:3 * n_tris], device=dev)  # [3T, 3]: cell, corner p, corner q
    c, p, q = v[:, 0], v[:, 1], v[:, 2]
    sp, sq = sdf[c, p], sdf[c, q]
    den = sp - sq
    t = torch.where(den.abs() > 1e-9, sp / torch.where(den == 0, 1e-9, den), 0.5).clamp(0.0, 1.0)
    xyz = pos[c, p] + t[:, None] * (pos[c, q] - pos[c, p])
    rgb = col[c, p] + t[:, None] * (col[c, q] - col[c, p])
    vl = torch.where(t < 0.5, lab[c, p], lab[c, q])
    rel = torch.stack([xyz[:, a].float() - base[a] for a in range(3)], dim=-1)
    vq = torch.round(rel / qscale).clamp(0, 65535).long()
    cq = torch.round(rgb.float() * 255.0).clamp(0, 255).long()
    lq = (vl.long() + 1).clamp(0, 255)
    vtx = torch.cat([vq, lq[:, None], cq], dim=1).cpu().numpy().reshape(-1, 3, 7)
    return dict(rows=sort_rows(vtx), meshed=meshed, cells=int(done.sum()))


def sort_rows(vtx: np.ndarray) -> np.ndarray:
    """[T, 3, 7] triangle vertices -> [T, 21] rows with each triangle's
    vertices in lexicographic order, so that a triangle's row does not
    depend on its winding or its first vertex."""
    order = np.lexsort(vtx.transpose(2, 0, 1)[::-1], axis=-1)
    srt = np.take_along_axis(vtx, order[..., None], axis=1)
    return srt.reshape(len(vtx), 21)


def scroll(pre: Dict, shift, trunc: float, dtype=torch.float32) -> Dict:
    """The volume moved by `shift` voxels: each voxel takes the values of
    the voxel `shift` further along, the voxels that enter are empty, and a
    cell touching an entering voxel is no longer meshed."""
    shape = tuple(pre["tsdf"].shape)
    dev = pre["tsdf"].device
    origin = np.asarray(pre["origin"], np.int64) + np.asarray(shift, np.int64)
    fresh = fresh_volume(shape, np.zeros(3), 1.0, trunc, dev)
    idx = [torch.arange(n, device=dev) + int(sh) for n, sh in zip(shape, shift)]
    ok = [(i >= 0) & (i < n) for i, n in zip(idx, shape)]
    inside = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    src = [i.clamp(0, n - 1) for i, n in zip(idx, shape)]
    out = {}
    for f in FIELDS:
        moved = pre[f][src[0]][:, src[1]][:, :, src[2]]
        if moved.is_floating_point():
            moved = moved.to(dtype)
        m = inside[..., None] if moved.dim() == 4 else inside
        out[f] = torch.where(m, moved, fresh[f].to(moved.dtype))
    out["cell_meshed"] = out["cell_meshed"] & ~any3(~inside)
    out["origin"] = origin
    return out
