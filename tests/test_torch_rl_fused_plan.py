"""K2's launch plan and task schedule on the CPU.

``kernels/rl_fused.py::launch_plan`` is the host's copy of the kernel's
plan (the card test holds it equal to the compiled one). Here: the default
group keeps the ratio store within half a volume and is the largest that
does, the groups cover nz, the store's head and ring cover every plane
that is read after it could be rewritten; and the kernel's schedule,
transliterated from ``csrc/rl_fused.cu`` (ticket order, ``decode``,
``wait_for``), is safe: every task waits only on tasks of earlier
tickets, a stage-2 task waits for every stage-1 group it reads, and a
stage-1 task that rewrites a ring slot waits for every stage-2 group that
reads the plane it replaces. No JAX, no card."""

import numpy as np
import pytest

from microimagelib_tpu_torch.kernels import rl_fused as KF
from microimagelib_tpu_torch.ops.conv_sep import RLFusedPlan, SepPlan, plan_rl_fused


def _gauss(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


PSFS = {"bench9": _gauss((9, 9, 9), (1.5, 1.5, 1.5)),
        "fusionA": _gauss((25, 25, 25), (3.5, 1.2, 1.2)),
        "fusionB": _gauss((25, 25, 25), (1.2, 1.2, 3.5))}
FUSION_SHAPE = (320, 512, 320)


def _plan(kind, shape):
    if kind == "skewed":
        # a back projector reaching 2 planes down and 10 up, and 1 row up
        # and 3 down (1 column up and 3 left): its halo ends on a tile edge
        rng = np.random.default_rng(3)

        def sep(a, ns, oy, ox):
            return SepPlan(shape=shape, a=a, b=ns - 1 - a,
                           tz=rng.random((1, ns), dtype=np.float32) / ns,
                           ty=rng.random((1, 5), dtype=np.float32) / 5, oy=oy,
                           tx=rng.random((1, 5), dtype=np.float32) / 5, ox=ox, rolls=None)

        return RLFusedPlan(sep(6, 13, -2, -2), sep(2, 13, -3, -1))
    psf = PSFS[kind]
    return plan_rl_fused(psf, np.ascontiguousarray(psf[::-1, ::-1, ::-1]), shape)


def _store_planes(kp):
    return kp["head"] + kp["ring"]


@pytest.mark.parametrize("kind", sorted(PSFS))
def test_default_group_keeps_the_store_within_half_a_volume(kind):
    """At the fusion grid the ratio lives in a ring: head + ring planes at
    most half the volume, with the largest group that keeps it there (a
    group one plane longer would not); the groups cover nz."""
    plan = _plan(kind, FUSION_SHAPE)
    kp = KF.launch_plan(plan)
    nz = FUSION_SHAPE[0]
    assert kp["ring"] > 0 and 2 * _store_planes(kp) <= nz, kp
    longer = KF.launch_plan(plan, group=kp["group"] + 1)
    assert longer["ring"] == 0 or 2 * _store_planes(longer) > nz
    g = kp["group"]
    assert kp["ngroups"] * g >= nz > (kp["ngroups"] - 1) * g
    assert kp["path"] >= 0                          # the specialised stages
    ring_bytes = kp["ring"] * 4 * FUSION_SHAPE[1] * FUSION_SHAPE[2]
    assert ring_bytes < 4 * np.prod(FUSION_SHAPE) // 2


@pytest.mark.parametrize("kind, shape", [("fusionA", (26, 48, 64)), ("fusionA", (9, 16, 32)),
                                         ("fusionB", (64, 128, 128))])
def test_default_plan_without_a_window_sized_group_stores_the_volume(kind, shape):
    """Where no group of at least the z window (the longer stage's z taps
    - 1) keeps the store within half the volume, one group of nz planes
    does the whole volume (view B at nz 64 would otherwise take 1-plane
    groups)."""
    kp = KF.launch_plan(_plan(kind, shape))
    assert (kp["group"], kp["ngroups"], kp["head"], kp["ring"]) == (shape[0], 1, shape[0], 0)


@pytest.mark.parametrize("kind", ["bench9", "skewed"])
def test_default_group_is_at_least_the_z_window(kind):
    shape = (128, 64, 64)
    plan = _plan(kind, shape)
    kp = KF.launch_plan(plan)
    assert kp["ring"] > 0 and 2 * _store_planes(kp) <= shape[0], kp
    assert kp["group"] >= max(plan.fwd.nsteps, plan.bp.nsteps) - 1


def _order(kp, tiles):
    """The ticket order the kernel's comment states: stage 1 of group k,
    then the natural stage-2 groups g >= deferred whose turn comes after
    stage 1 of min(ngroups - 1, g + lag); the deferred groups last."""
    ng, g0, lag = kp["ngroups"], kp["deferred"], kp["lag"]
    order = []
    for k in range(ng):
        order += [(0, k, t) for t in range(tiles[0])]
        for g in range(g0, ng):
            if min(ng - 1, g + lag) == k:
                order += [(1, g, t) for t in range(tiles[1])]
    for g in range(g0):
        order += [(1, g, t) for t in range(tiles[1])]
    return order


def _decode(kp, tiles, t):
    """csrc/rl_fused.cu::decode."""
    ng, g0, lag = kp["ngroups"], kp["deferred"], kp["lag"]
    t1, t2 = tiles

    def stage2_by(j):
        n = ng - g0
        if j < 0:
            return 0
        if j >= ng - 1:
            return n
        return min(max(j - lag - g0 + 1, 0), n)

    def stage1_ticket(k):
        return k * t1 + t2 * stage2_by(k - 1)

    end1 = ng * t1 + t2 * (ng - g0)
    if t >= end1:
        return (1, (t - end1) // t2, (t - end1) % t2)
    lo, hi = 0, ng - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if stage1_ticket(mid) <= t:
            lo = mid
        else:
            hi = mid - 1
    off = t - stage1_ticket(lo)
    if off < t1:
        return (0, lo, off)
    off -= t1
    return (1, g0 + stage2_by(lo - 1) + off // t2, off % t2)


def _tile_span(lo, hi, n, length, ntiles):
    """csrc/rl_fused.cu::tile_span: the cyclic tiles rows lo .. hi touch."""
    if hi - lo + 1 + length > n:
        return list(range(ntiles))
    a, b = (lo % n) // length, (hi % n) // length
    return [(a + i) % ntiles for i in range((b - a) % ntiles + 1)]


class Geo:
    """A stage's tiles on the grid, from the plan's tile and SepPlan."""

    def __init__(self, shape, ty, tx, sep):
        self.ny, self.nx = shape[1:]
        self.ty, self.tx = ty, tx
        self.tiles_y, self.tiles_x = -(-self.ny // ty), -(-self.nx // tx)
        self.oy, self.ox = sep.oy, sep.ox
        self.ly, self.lx = sep.ty.shape[1], sep.tx.shape[1]

    def origin(self, tile):
        return tile // self.tiles_x * self.ty, tile % self.tiles_x * self.tx

    def tile(self, r, c):
        return r * self.tiles_x + c


def _waits(kp, nz, a2, b2, geo, stage, group, tile):
    """csrc/rl_fused.cu::wait_for: the (stage, group, tile) flags waited on."""
    g, ng = kp["group"], kp["ngroups"]
    p1, p2 = geo
    z0 = group * g
    zn = min(g, nz - z0)
    if stage == 0:
        if kp["ring"] == 0:
            return []
        lo, hi = max(kp["head"], z0 - kp["ring"]), z0 + zn - 1 - kp["ring"]
        if hi < lo:
            return []
        glo = max(kp["deferred"], (lo - b2 - g + 1) // g)
        ghi = min(ng - 1, (hi + a2) // g)
        y0, x0 = p1.origin(tile)
        y1, x1 = min(y0 + p1.ty, p1.ny) - 1, min(x0 + p1.tx, p1.nx) - 1
        rows = _tile_span(y0 + p2.oy, y1 + p2.oy + p2.ly - 1, p2.ny, p2.ty, p2.tiles_y)
        cols = _tile_span(x0 + p2.ox, x1 + p2.ox + p2.lx - 1, p2.nx, p2.tx, p2.tiles_x)
        return [(1, k, p2.tile(r, c)) for k in range(glo, ghi + 1) for r in rows for c in cols]
    lo, hi = z0 - a2, z0 + zn - 1 + b2
    if hi - lo + 1 + g > nz:
        ks = list(range(ng))
    else:
        ka, kb = (lo % nz) // g, (hi % nz) // g
        ks = [(ka + i) % ng for i in range((kb - ka) % ng + 1)]
    y0, x0 = p2.origin(tile)
    rows = _tile_span(y0 - p2.oy - p2.ly + 1, y0 + p2.ty - 1 - p2.oy, p1.ny, p1.ty, p1.tiles_y)
    cols = _tile_span(x0 - p2.ox - p2.lx + 1, x0 + p2.tx - 1 - p2.ox, p1.nx, p1.tx, p1.tiles_x)
    return [(0, k, p1.tile(r, c)) for k in ks for r in rows for c in cols]


def _slot(kp, z):
    return z if z < kp["head"] else kp["head"] + (z - kp["head"]) % kp["ring"]


def _geo(plan, kp):
    return (Geo(plan.shape, kp["ty_fwd"], kp["tx_fwd"], plan.fwd),
            Geo(plan.shape, kp["ty_bp"], kp["tx_bp"], plan.bp))


@pytest.mark.parametrize("case", [("fusionA", FUSION_SHAPE, 0), ("fusionA", FUSION_SHAPE, 8),
                                  ("fusionB", FUSION_SHAPE, 0), ("bench9", FUSION_SHAPE, 3),
                                  ("fusionA", (26, 48, 64), 0)],
                         ids=lambda c: f"{c[0]}-{c[1][0]}-g{c[2]}")
def test_decode_follows_the_ticket_order(case):
    kind, shape, group = case
    plan = _plan(kind, shape)
    kp = KF.launch_plan(plan, group=group)
    p1, p2 = _geo(plan, kp)
    tiles = (p1.tiles_y * p1.tiles_x, p2.tiles_y * p2.tiles_x)
    order = _order(kp, tiles)
    assert len(order) == kp["ngroups"] * sum(tiles)
    step = max(1, len(order) // 5000)
    assert all(_decode(kp, tiles, t) == order[t] for t in range(0, len(order), step))
    assert _decode(kp, tiles, len(order) - 1) == order[-1]


# (plan, grid, group) on grids of a few tiles, so that halos wrap
SCHEDULE_CASES = [
    ("fusionA", (83, 48, 96), 8), ("fusionA", (83, 48, 96), 5),
    ("fusionB", (90, 64, 96), 8), ("bench9", (61, 80, 64), 1),
    ("bench9", (61, 80, 64), 3), ("skewed", (57, 128, 160), 4),
    ("skewed", (57, 40, 72), 5), ("bench9", (128, 64, 64), 0),
    ("fusionA", (26, 48, 64), 0),
]


@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}-g{c[2]}")
def test_schedule_waits_cover_every_read_and_rewrite(case):
    kind, shape, group = case
    plan = _plan(kind, shape)
    kp = KF.launch_plan(plan, group=group)
    nz, ny, nx = shape
    a2, b2 = plan.bp.a, plan.bp.nsteps - 1 - plan.bp.a
    geo = p1, p2 = _geo(plan, kp)
    tiles = (p1.tiles_y * p1.tiles_x, p2.tiles_y * p2.tiles_x)
    order = _order(kp, tiles)
    ticket = {task: t for t, task in enumerate(order)}
    g = kp["group"]
    groups = range(kp["ngroups"])

    def planes(grp):
        return set(range(grp * g, min(grp * g + g, nz)))

    def reads(grp):   # the ratio planes stage 2 of grp reads
        return {(z0 + s - a2) % nz for z0 in planes(grp) for s in range(a2 + b2 + 1)}

    def area1(u):     # the rows and columns a stage-1 tile writes
        y0, x0 = p1.origin(u)
        return set(range(y0, min(y0 + p1.ty, ny))), set(range(x0, min(x0 + p1.tx, nx)))

    def area2(w):     # the rows and columns a stage-2 tile's halo reads
        y0, x0 = p2.origin(w)
        return ({(y0 - p2.oy - p2.ly + 1 + i) % ny for i in range(p2.ty + p2.ly - 1)},
                {(x0 - p2.ox - p2.lx + 1 + i) % nx for i in range(p2.tx + p2.lx - 1)})

    for task in order:
        wait = _waits(kp, nz, a2, b2, geo, *task)
        assert all(ticket[w] < ticket[task] for w in wait), task
        stage, grp, tile = task
        if stage == 1:
            rows, cols = area2(tile)
            need = {(0, k, u) for k in groups if planes(k) & reads(grp)
                    for u in range(tiles[0]) if area1(u)[0] & rows and area1(u)[1] & cols}
            assert need <= set(wait), (task, need - set(wait))
    if kp["ring"] == 0:
        assert kp["head"] == nz
        return
    assert _store_planes(kp) < nz
    for k in groups:
        for u in range(tiles[0]):
            wait = set(_waits(kp, nz, a2, b2, geo, 0, k, u))
            rows, cols = area1(u)
            for z in planes(k):
                old = z - kp["ring"]
                if z < kp["head"] or old < kp["head"]:
                    continue
                assert _slot(kp, old) == _slot(kp, z)
                readers = {(1, r, w) for r in groups if old in reads(r)
                           for w in range(tiles[1])
                           if area2(w)[0] & rows and area2(w)[1] & cols}
                assert readers and readers <= wait, (k, u, z, readers - wait)
    # a plane kept in the ring is never read after its slot is rewritten,
    # the deferred groups included: their reads are the head and the last
    # planes, which no later plane replaces
    for r in range(kp["deferred"]):
        for z in reads(r):
            assert z < kp["head"] or z + kp["ring"] >= nz, (r, z)
