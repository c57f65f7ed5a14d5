"""The bf16 chunked prefill's wgmma body (``paged_prefill_wgmma_kernel`` in
``csrc/paged_attention.cu``) on the CPU, where it cannot run: which calls
``prefill_plan`` and the wrapper send to it, the host copy of the key tiles
and pages its 128-row blocks walk (``ops.prefill_walk``) against the JAX
oracle's mask, and a host emulation of its arithmetic against the JAX
oracle.

The emulation repeats what each 64-row warpgroup of the kernel computes:
the 64-key tiles its block walks, each read page by page from the pool
rows the walk names (zeros past the pool), f32 scores scaled after the
product, an online softmax in log2 units (a masked key at the finite
NEG_INF for the max, exactly 0 after it; the mask only on "edge" tiles,
"empty" tiles skipped), P rounded to bf16 before P V with l summing the
rounded P, and the output rounded once to bf16.  Held against the JAX
oracle (``repro.kernels.paged_attention.ref.paged_prefill_attention_ref``,
f32) on the same bf16-valued inputs at the bf16 chunked-prefill bar that
``chip_smoke.py`` holds the kernel to, 2e-2 absolute (one bf16 rounding of
outputs up to ~4 in the rows that see few keys is 1.6e-2; P's rounding,
2^-9 relative, weighs numerator and denominator alike), on the rows that
see a key: the oracle leaves rows that see none as finite garbage, the
kernel writes 0 there (checked exactly).  The walk is exact integer logic.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.paged_attention.ref import \
    paged_prefill_attention_ref as jax_prefill_ref
from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.kernels.paged_attention import ops as tpa

TOL = 2e-2
# the oracle compiled once a shape (eager JAX compiles each of its
# operations a shape: seconds a call)
jax_ref = jax.jit(jax_prefill_ref, static_argnames="window")
LOG2E = 1.4426950408889634
ROWS, KEYS = tpa.PREFILL_WGMMA_ROWS, tpa.PREFILL_WGMMA_KEYS


# ---------------------------------------------------------------------------
# the plan and the wrapper's send
# ---------------------------------------------------------------------------
# (tag, D, body): the served shapes (pages of 16 rows): zamba2-7b's and
# stablelm-12b's 512-token chunks and shorter ones, stablelm-12b's CLI
# 16-row chunks, LLaVA's image chunk and text chunks, whisper-small's and
# granite-moe's; the chunk's length does not decide
SERVED = [("zamba2-c512", 112, "wgmma"),
          ("zamba2-c128", 112, "wgmma"),
          ("zamba2-c32", 112, "wgmma"),
          ("zamba2-c16", 112, "wgmma"),
          ("stablelm-c512", 160, "wgmma"),
          ("stablelm-c64", 160, "wgmma"),
          ("stablelm-cli-c16", 160, "wgmma"),
          ("llava-c1024", 128, "wgmma"),
          ("llava-c32", 128, "wgmma"),
          ("whisper-c64", 64, "tile"),
          ("granite-c512", 64, "tile")]


@pytest.mark.parametrize("tag,D,body", SERVED, ids=[s[0] for s in SERVED])
def test_prefill_plan_at_the_served_shapes(tag, D, body):
    assert tpa.prefill_plan(D, 16) == body


@pytest.mark.parametrize("D", [64, 80, 112, 128, 160, 256])
def test_prefill_plan_takes_only_its_widths_and_pages(D):
    """The body takes D = 112, 128 and 160 over pages of 8, 16 or 32
    rows; other pages and the other widths stay on the tile."""
    for page in (4, 8, 16, 32, 64):
        want = D in (112, 128, 160) and page in (8, 16, 32)
        assert (tpa.prefill_plan(D, page) == "wgmma") == want


def _send(monkeypatch, dtype, B, C, H, Kh, D, page=16, window=0):
    """(the C entry the wrapper calls, its arguments, the launch counters
    it moved) for CPU tensors standing in for the card's."""
    seen = []

    def function(lib, name, argtypes):
        return lambda *args: seen.append((name, args)) or 0
    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(tpa._build, "function", function)
    n_pages, max_pages = 12, 6
    q = torch.zeros((B, C, H, D), dtype=dtype)
    kp = torch.zeros((n_pages, page, Kh, D), dtype=dtype)
    tables = torch.zeros((B, max_pages), dtype=torch.int32)
    ctx = torch.zeros(B, dtype=torch.int32)
    K.reset_launches()
    tpa.paged_prefill_attention(q, kp, kp.clone(), tables, ctx, window=window)
    (name, args), = seen
    return name, args, dict(K.launches)


@pytest.mark.parametrize("D", [112, 128, 160])
def test_wrapper_runs_bf16_chunks_on_the_wgmma_body(monkeypatch, D):
    """bf16 at D = 112 / 128 / 160, chunks of 200, 16 and 1 rows: the
    wgmma entry, counted as a prefill call and a wgmma one, handed the
    pool's rows; f32 and D = 64 stay on the tile's entry."""
    for C in (200, 16, 1):
        name, args, n = _send(monkeypatch, torch.bfloat16, 2, C, 8, 2, D,
                              window=30)
        assert name == "paged_prefill_attention_wgmma"
        # ... out, B C H Kh D page max_pages window pool_rows, stream
        assert args[6:15] == (2, C, 8, 2, D, 16, 6, 30, 12 * 16)
        assert n["paged_prefill_attention"] == 1
        assert n["paged_prefill_attention_wgmma"] == 1
    for dtype, C, d in ((torch.float32, 200, D), (torch.bfloat16, 200, 64)):
        name, _, n = _send(monkeypatch, dtype, 2, C, 8, 2, d)
        assert name == "paged_prefill_attention"
        assert n["paged_prefill_attention"] == 1
        assert n["paged_prefill_attention_wgmma"] == 0
    K.reset_launches()


@pytest.mark.parametrize("page", [4, 64])
def test_wrapper_keeps_pages_the_body_does_not_take_on_the_tile(monkeypatch,
                                                                 page):
    """A long bf16 chunk at a built width over pages the body's TMA boxes
    do not take runs on the tile, which reads any page."""
    name, _, n = _send(monkeypatch, torch.bfloat16, 1, 256, 4, 4, 112,
                       page=page)
    assert name == "paged_prefill_attention"
    assert n["paged_prefill_attention"] == 1
    assert n["paged_prefill_attention_wgmma"] == 0
    K.reset_launches()


# ---------------------------------------------------------------------------
# the walk against the JAX oracle's mask
# ---------------------------------------------------------------------------
def _jax_mask(C, ctx, n_keys, window):
    """[B, C, n_keys] bool: the (chunk row, key) pairs the JAX oracle lets
    through for lanes of ctx[b] cached keys, read from its output on
    identity pages: key j's score is j / n_keys and its value row is
    one-hot at j, so out[b, c, j] > 0 exactly where row c sees key j, with
    weights that grow with j; a row that sees no key comes out uniform
    over every key (the oracle's finite garbage), which no row that sees
    keys does (n_keys > 1)."""
    B = len(ctx)
    q = np.zeros((B, C, 1, n_keys), np.float32)
    q[..., 0] = math.sqrt(n_keys)
    k = np.zeros((n_keys, 1, 1, n_keys), np.float32)
    k[:, 0, 0, 0] = np.arange(n_keys) / n_keys
    v = np.eye(n_keys, dtype=np.float32)[:, None, None]
    tables = np.broadcast_to(np.arange(n_keys, dtype=np.int32), (B, n_keys))
    out = np.asarray(jax_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx, jnp.int32), window=window))[:, :, 0]
    empty = np.all(out == out[..., :1], axis=-1)
    return torch.from_numpy((out > 0) & ~empty[..., None])


def _rule(C, ctx, n_keys, window):
    """The kernel's rule: key j < n_keys, j <= ctx + c, inside the window."""
    qpos = ctx + torch.arange(C)[:, None]
    key = torch.arange(n_keys)[None]
    vis = key <= qpos
    if window:
        vis &= key > qpos - window
    return vis


def _walk_holds(C, ctx, table, page, window, pool_rows, mask):
    """Every 128-row block's walk: whole 64-key tiles in order, inside the
    table's keys; each visible pair of the block's rows in a tile its
    warpgroup does not skip; "full" for a warpgroup only where every pair
    of its 64 rows and the tile's keys is inside C x n_keys and visible,
    "empty" where none is, "edge" else; page i of a tile at key k0 read
    from table[(k0 / page) + i] * page, or from past the pool when that
    column is past the table."""
    n_keys = len(table) * page
    seen = torch.zeros_like(mask)
    for q0 in range(0, C, ROWS):
        walk = tpa.prefill_walk(q0, C, ctx, table, page, window, pool_rows)
        starts = [k0 for k0, _, _ in walk]
        assert starts == list(range(starts[0], starts[0] + KEYS * len(walk),
                                    KEYS)) if walk else True
        for k0, kinds, rows in walk:
            assert 0 <= k0 < n_keys and len(rows) == KEYS // page
            for i, row in enumerate(rows):
                j = (k0 + i * page) // page
                assert row == (table[j] * page if j < len(table)
                               else pool_rows)
            for w, kind in enumerate(kinds):
                r0 = q0 + 64 * w
                sub = mask[r0:r0 + 64, k0:k0 + KEYS]
                inside = r0 + 64 <= C and k0 + KEYS <= n_keys
                want = ("empty" if not sub.any() else
                        "full" if inside and sub.all() else "edge")
                assert kind == want, (q0, k0, w, kind, want)
                if kind != "empty":
                    seen[r0:r0 + 64, k0:k0 + KEYS] = True
    assert not (mask & ~seen).any()


# (C, ctx, max_pages, page, window): a first chunk, a later one over a
# prefix, a ragged block, a window crossing tiles, a chunk past its table
# (keys past max_pages * page), rows whose window lies past the table, a
# 32-row chunk (one block, a quarter of its rows)
WALK_CASES = [(256, 0, 16, 16, 0), (200, 300, 32, 16, 0),
              (130, 40, 11, 16, 0), (300, 100, 13, 32, 70),
              (150, 10, 5, 8, 0), (140, 200, 8, 8, 24),
              (32, 600, 40, 16, 0)]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=["first", "prefix", "ragged", "window",
                              "past-table", "window-past-table",
                              "short-chunk"])
def test_prefill_walk_matches_the_jax_mask(case):
    C, ctx, max_pages, page, window = case
    n_keys = max_pages * page
    mask, = _jax_mask(C, [ctx], n_keys, window)
    assert torch.equal(mask, _rule(C, ctx, n_keys, window))
    table = np.random.default_rng(C).permutation(4 * max_pages)[:max_pages]
    _walk_holds(C, ctx, table.tolist(), page, window, 4 * max_pages * page,
                mask)


# ---------------------------------------------------------------------------
# the arithmetic against the JAX oracle
# ---------------------------------------------------------------------------
def wgmma_prefill_ref(q, k_pages, v_pages, tables, ctx_lens, window=0):
    """out in bf16 as ``paged_prefill_wgmma_kernel`` computes it: q [B, C,
    H, D], pages [n_pages, page, Kh, D], f32 tensors holding bf16
    values."""
    B, C, H, D = q.shape
    n_pages, page, Kh, _ = k_pages.shape
    pool_rows, G = n_pages * page, H // Kh
    kpool = k_pages.reshape(pool_rows, Kh, D)
    vpool = v_pages.reshape(pool_rows, Kh, D)
    scale_log2 = LOG2E / math.sqrt(D)
    n_keys = tables.shape[1] * page
    out = torch.zeros((B, C, H, D))

    def rows_of(pool, starts, kh):
        return torch.cat([pool[r:r + page, kh] if r < pool_rows
                          else torch.zeros((page, D)) for r in starts])
    for b in range(B):
        ctx, table = int(ctx_lens[b]), tables[b].tolist()
        vis_all = _rule(C, ctx, n_keys, window)
        for q0 in range(0, C, ROWS):
            walk = tpa.prefill_walk(q0, C, ctx, table, page, window,
                                    pool_rows)
            for h in range(H):
                for w in (0, 1):
                    r0 = q0 + 64 * w
                    r1 = min(r0 + 64, C)
                    if r0 >= C:
                        continue
                    m = torch.full((r1 - r0,), NEG_INF)
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros((r1 - r0, D))
                    for k0, kinds, starts in walk:
                        if kinds[w] == "empty":
                            continue
                        kt = rows_of(kpool, starts, h // G)
                        vt = rows_of(vpool, starts, h // G)
                        s = q[b, r0:r1, h] @ kt.T
                        vis = vis_all[r0:r1, k0:k0 + KEYS]
                        vis = torch.nn.functional.pad(
                            vis, (0, KEYS - vis.shape[1]))
                        if kinds[w] == "full":
                            assert vis.all()
                        mx = torch.where(vis, s, NEG_INF).amax(1)
                        m_new = torch.maximum(m, torch.where(
                            mx == NEG_INF, NEG_INF, mx * scale_log2))
                        alpha = torch.exp2(m - m_new)
                        p = torch.where(vis, torch.exp2(
                            s * scale_log2 - m_new[:, None]), 0.0)
                        p = p.bfloat16().float()
                        l = alpha * l + p.sum(1)
                        acc = alpha[:, None] * acc + p @ vt
                        m = m_new
                    out[b, r0:r1, h] = acc / l.clamp_min(1e-30)[:, None]
    return out.bfloat16()


def _problem(rng, ctx, C, H, Kh, D, page, max_pages, padded=()):
    """bf16-valued f32 q, K/V pages (the last one scratch) and tables: lane
    b owns distinct pages for its ctx + C keys, a padded lane (in
    ``padded``) and every row's tail name the scratch page."""
    n_pages = len(ctx) * max_pages + 1

    def bf16(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float()
    q = bf16(len(ctx), C, H, D)
    kp, vp = bf16(n_pages, page, Kh, D), bf16(n_pages, page, Kh, D)
    tables = np.full((len(ctx), max_pages), n_pages - 1, np.int32)
    free = list(rng.permutation(n_pages - 1))
    for b, c in enumerate(ctx):
        if b not in padded:
            for j in range(min(max_pages, -(-(c + C) // page))):
                tables[b, j] = free.pop()
    return q, kp, vp, torch.from_numpy(tables), torch.tensor(ctx,
                                                            dtype=torch.int32)


def _holds(q, kp, vp, tables, ctx, window):
    """The emulation against the JAX oracle on the rows that see a key;
    exactly 0 on the rows that see none."""
    got = wgmma_prefill_ref(q, kp, vp, tables, ctx, window).float()
    want = np.asarray(jax_ref(
        *(jnp.asarray(t.numpy()) for t in (q, kp, vp, tables, ctx)),
        window=window))
    n_keys = tables.shape[1] * kp.shape[1]
    for b in range(q.shape[0]):
        seen = _rule(q.shape[1], int(ctx[b]), n_keys, window).any(1)
        assert torch.isfinite(got[b]).all()
        assert not got[b][~seen].any()
        if seen.any():
            err = np.abs(got[b][seen].numpy() - want[b][seen.numpy()]).max()
            assert err <= TOL, (b, err)


# (ctx per lane, C, H, Kh, page, max_pages, window, padded lanes): a first
# chunk of one block and a later one of two blocks (the smoke's c512 shape
# cut down), GQA, a window, pages of 8 and 32, a padded lane, keys past
# the table, a lane whose window lies past its table, a 32-row chunk of
# a later prefill
ARITH_CASES = [([0, 40], 130, 2, 2, 16, 12, 0, ()),
               ([0, 64, 5], 200, 4, 1, 16, 18, 0, (2,)),
               ([30, 7], 150, 2, 1, 8, 20, 40, ()),
               ([0, 96], 140, 2, 2, 32, 4, 0, ()),
               ([10, 300], 129, 2, 2, 16, 10, 25, ()),
               ([300, 17], 32, 4, 1, 16, 22, 0, ())]


@pytest.mark.parametrize("case", ARITH_CASES,
                         ids=["two-lanes", "gqa-padded-lane", "window-page8",
                              "page32-past-table", "window-past-table",
                              "short-chunk"])
@pytest.mark.parametrize("D", [112, 128, 160])
def test_wgmma_prefill_arithmetic_matches_the_jax_oracle(case, D):
    ctx, C, H, Kh, page, max_pages, window, padded = case
    rng = np.random.default_rng(D + C + page)
    _holds(*_problem(rng, ctx, C, H, Kh, D, page, max_pages, padded),
           window)


@settings(max_examples=20, deadline=None)
@given(ctx=st.lists(st.integers(0, 200), min_size=1, max_size=3),
       C=st.integers(1, 200), G=st.sampled_from([1, 2, 4]),
       window=st.sampled_from([0, 1, 17, 64, 150]),
       page=st.sampled_from([8, 16, 32]), slack=st.integers(-6, 3),
       padded=st.booleans())
def test_wgmma_prefill_walk_and_arithmetic_property(ctx, C, G, window, page,
                                                    slack, padded):
    """Drawn lanes, chunks, GQA groups, windows and pages: each lane's walk
    against the oracle's mask, and (at D = 16) the emulation against the
    oracle.  ``slack`` cuts the table short of or past the longest lane's
    keys, so chunks reach past their table and windows past it; with
    ``padded`` the first lane's table names only the scratch page."""
    max_pages = max(1, -(-(max(ctx) + C) // page) + slack)
    n_keys = max_pages * page
    rng = np.random.default_rng(sum(ctx) + C + G + page)
    q, kp, vp, tables, ctx_t = _problem(
        rng, ctx, C, G, 1, 16, page, max_pages, (0,) if padded else ())
    masks = _jax_mask(C, ctx, n_keys, window)
    for b, c in enumerate(ctx):
        assert torch.equal(masks[b], _rule(C, c, n_keys, window))
        _walk_holds(C, c, tables[b].tolist(), page, window,
                    kp.shape[0] * page, masks[b])
    _holds(q, kp, vp, tables, ctx_t, window)
