"""The port's paged cache pool (``repro_torch.runtime.cachepool``) against
the JAX package's, mirroring tests/test_cachepool.py on the deepseek_7b
and gemma2_2b smoke models (gemma2's local layers: an 8-row window,
its own page group).

* host state equal to the reference's: the allocator's hand-out order
  and refcounts under one random schedule, ``token_hash_chain`` digests
  byte for byte, ``PrefixCache`` matches and LRU order, and the block
  tables, refcounts and free lists of ``PagedCachePool`` after one
  scripted admit / ensure / copy-on-write / evict / free sequence;
* device state: a slot written through ``write`` reads back bit for bit
  and its pages equal the reference pool's (the port's extra sink page
  skipped), an empty slot's view is pristine, ``commit_rows`` leaves
  masked lanes untouched and sends their rows to the sink page, which
  no view reads;
* the invariants and rejections of tests/test_cachepool.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _pbt import given, settings, strategies as st  # noqa: E402
from repro.configs import smoke as j_smoke  # noqa: E402
from repro.runtime import cachepool as jpool  # noqa: E402
from repro_torch.configs import smoke  # noqa: E402
from repro_torch.models import init_caches, reset_cache_slot, write_cache_slot  # noqa: E402
from repro_torch.runtime.cachepool import (  # noqa: E402
    ContiguousCacheOps,
    PageAllocator,
    PagedCachePool,
    PrefixCache,
    token_hash_chain,
)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b), strict=True))


def _random_tree(tree, seed):
    g = torch.Generator().manual_seed(seed)

    def fill(x):
        if x.dtype == torch.int32:
            return torch.randint(-1, 32, x.shape, generator=g, dtype=torch.int32)
        return torch.randn(x.shape, generator=g).to(x.dtype)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(v) for k, v in node.items()}
    return walk(tree)


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------


def _check_conservation(alloc):
    live = alloc.live()
    assert alloc.n_free + len(live) + 1 == alloc.n_pages
    assert 0 not in live
    assert alloc.refcount[0] == 1


@settings(max_examples=20)
@given(st.integers(min_value=2, max_value=24), st.integers(min_value=0, max_value=2**31 - 1))
def test_allocator_churn_equals_reference(n_pages, seed):
    """Under one random alloc / incref / decref schedule the port hands out
    the reference's page ids, with its refcounts and free list, and keeps
    the invariants; full churn drains the pool."""
    rng = np.random.default_rng(seed)
    alloc, ref = PageAllocator(n_pages), jpool.PageAllocator(n_pages)
    held = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 and alloc.n_free:
            pid = alloc.alloc()
            assert pid == ref.alloc() and pid != 0
            held.append(pid)
        elif op == 1 and held:
            pid = held[rng.integers(len(held))]
            alloc.incref(pid)
            ref.incref(pid)
            held.append(pid)
        elif op == 2 and held:
            pid = held.pop(rng.integers(len(held)))
            assert alloc.decref(pid) == ref.decref(pid) == (pid not in held)
        assert (alloc.refcount >= 0).all()
        _check_conservation(alloc)
        assert (alloc.refcount == ref.refcount).all() and alloc._free == ref._free
    while held:
        alloc.decref(held.pop())
    assert alloc.n_free == n_pages - 1 and alloc.live() == []


def test_allocator_exhaustion_underflow_and_zero_page():
    alloc = PageAllocator(6)
    assert sorted(alloc.alloc() for _ in range(5)) == [1, 2, 3, 4, 5]
    with pytest.raises(MemoryError):
        alloc.alloc()
    alloc = PageAllocator(4)
    pid = alloc.alloc()
    alloc.decref(pid)
    with pytest.raises(ValueError):
        alloc.decref(pid)
    with pytest.raises(ValueError):
        alloc.incref(pid)
    assert alloc.decref(0) is False
    alloc.incref(0)
    assert alloc.refcount[0] == 1
    with pytest.raises(ValueError):
        PageAllocator(1)


# ---------------------------------------------------------------------------
# the prefix-hash contract and the prefix cache
# ---------------------------------------------------------------------------


@settings(max_examples=20)
@given(st.integers(min_value=1, max_value=8), st.integers(min_value=0, max_value=2**31 - 1))
def test_hash_chain_equals_reference_and_prefix_property(page_size, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 100000, size=4 * page_size + rng.integers(0, page_size)).tolist()
    b = list(a)
    flip = int(rng.integers(0, len(b)))
    b[flip] = int(b[flip]) + 1
    ca, cb = token_hash_chain(a, page_size), token_hash_chain(b, page_size)
    assert ca == jpool.token_hash_chain(a, page_size)  # byte for byte
    assert cb == jpool.token_hash_chain(b, page_size)
    assert len(ca) == len(a) // page_size
    for i in range(len(cb)):
        assert (ca[i] == cb[i]) == (i < flip // page_size)


def test_hash_chain_ignores_partial_tail():
    assert token_hash_chain([1, 2, 3], 4) == []
    assert token_hash_chain([1, 2, 3, 4, 9, 9], 4) == token_hash_chain([1, 2, 3, 4], 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_equals_reference_under_one_schedule(seed):
    """insert / match / evict_lru on both caches: the same matches, LRU
    order, refcounts and freed counts; the cache owns its references."""
    rng = np.random.default_rng(seed)
    (a, c), (ja, jc) = caches = [(al, PrefixCache(al)) for al in (PageAllocator(12),)] + [
        (al, jpool.PrefixCache(al)) for al in (jpool.PageAllocator(12),)]
    runs = []
    for _ in range(80):
        op = int(rng.integers(0, 4))
        key = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        resident = [r for r in runs if r[0] in c._entries]
        pick = resident[int(rng.integers(len(resident)))] if resident else None
        if op == 0 and a.n_free:
            base = list(pick[1]) if pick and rng.integers(2) else []
            outs = []
            for al, ca in caches:
                pid = al.alloc()
                outs.append((pid, ca.insert(key, base + [pid])))
                al.decref(pid)  # the cache now the sole owner of the new page
            assert outs[0] == outs[1]
            runs.append((key, tuple(base + [outs[0][0]])))
        elif op == 1:
            assert c.evict_lru() == jc.evict_lru()
        elif op == 2 and pick:
            chain = [bytes(32), pick[0]]
            assert c.match(chain) == jc.match(chain)
        elif op == 3 and pick:
            assert c.insert(*pick) is jc.insert(*pick) is False
        assert list(c._entries.items()) == list(jc._entries.items())
        assert (a.refcount == ja.refcount).all() and (a.refcount >= 0).all()
        _check_conservation(a)
    for al, ca in caches:
        ca.drop_all()
        assert al.live() == []


def test_prefix_cache_longest_match_and_lru():
    alloc = PageAllocator(16)
    cache = PrefixCache(alloc)
    chain = token_hash_chain(list(range(12)), 4)
    pages = [alloc.alloc() for _ in range(3)]
    for i in range(1, 4):
        cache.insert(chain[i - 1], pages[:i])
    assert alloc.refcount[pages[0]] == 1 + 3 and alloc.refcount[pages[2]] == 1 + 1
    assert cache.match(chain) == (3, tuple(pages))
    assert cache.match(chain[:2]) == (2, tuple(pages[:2]))
    assert cache.match(token_hash_chain([9] * 8, 4)) == (0, ())
    for p in pages:
        alloc.decref(p)
    assert alloc.live() != []
    while len(cache):
        cache.evict_lru()
    assert alloc.live() == []


# ---------------------------------------------------------------------------
# ContiguousCacheOps == the helpers
# ---------------------------------------------------------------------------


def test_contiguous_ops_bit_identical_to_helpers():
    cfg = smoke("gemma2_2b")
    ops = ContiguousCacheOps(cfg, n_slots=3, max_len=32, device="cpu")
    pool_ops, pool_ref = ops.alloc(), init_caches(cfg, 3, 32, device="cpu")
    assert _tree_equal(pool_ops, pool_ref)
    single = _random_tree(init_caches(cfg, 1, 32, device="cpu"), 0)
    ops.write(pool_ops, single, 1)
    write_cache_slot(pool_ref, single, 1)
    assert _tree_equal(pool_ops, pool_ref)
    assert _tree_equal(ops.read(pool_ops, 1), single)
    snap = ops.snapshot(pool_ops, 1)
    ops.reset(pool_ops, 1)
    reset_cache_slot(pool_ref, cfg, 1)
    assert _tree_equal(pool_ops, pool_ref)
    ops.restore(pool_ops, snap, 1)
    assert _tree_equal(ops.read(pool_ops, 1), single)


# ---------------------------------------------------------------------------
# PagedCachePool
# ---------------------------------------------------------------------------


def _pools(arch="deepseek_7b", n_slots=2, max_len=32, page_size=8, **kw):
    port = PagedCachePool(smoke(arch), n_slots, max_len, page_size, device="cpu", **kw)
    ref = jpool.PagedCachePool(j_smoke(arch), n_slots, max_len, page_size, **kw)
    return port, port.alloc(), ref, ref.alloc()


def _host_state_equal(port, ref):
    assert port.groups.keys() == ref.groups.keys()
    for gk, g in port.groups.items():
        r = ref.groups[gk]
        assert (g["table"] == r["table"]).all(), gk
        assert (g["alloc"].refcount == r["alloc"].refcount).all(), gk
        assert g["alloc"]._free == r["alloc"]._free, gk
        assert g["alloc"].high_water == r["alloc"].high_water, gk
    if port.prefix is not None:
        assert list(port.prefix._entries.items()) == list(ref.prefix._entries.items())


def test_paged_lifecycle_host_state_equals_reference():
    """One scripted sequence on both pools (sharing on, a tight pool):
    admissions with a prefix hit, rows past the prompt, copy-on-write of a
    shared block, capacity checks that evict LRU prefix entries, frees."""
    port, ps, ref, rs = _pools(page_size=4, n_pages=12, prefix_sharing=True)
    a = list(range(1, 15))                 # 3 full pages + a partial one
    b = list(range(1, 9)) + [50, 51, 52]   # shares 2 pages with a
    c = list(range(100, 117))              # disjoint, 4 full pages + 1

    jstate = [rs]  # the reference's calls donate the state they are given

    def both(name, *args):
        out = getattr(port, name)(ps, *args), getattr(ref, name)(jstate[0], *args)
        jstate[0] = out[1][0] if isinstance(out[1], tuple) else out[1]
        _host_state_equal(port, ref)
        return out

    (_, m0, ch0), (_, jm0, jch0) = both("prepare_admission", 0, a)
    assert (m0, ch0) == (jm0, jch0) and m0 == 0
    assert port.finish_admission(0, ch0, m0) == ref.finish_admission(0, jch0, jm0) == 3
    (_, m1, ch1), (_, jm1, _) = both("prepare_admission", 1, b)
    assert m1 == jm1 == 8
    port.finish_admission(1, ch1, m1)
    ref.finish_admission(1, ch1, jm1)
    _host_state_equal(port, ref)
    both("ensure_rows", 0, 14, 17)         # a fresh block past the prompt
    both("ensure_rows", 1, 4, 7)           # block 1 is shared: copy-on-write
    assert port._m_cow.value() == 1
    port.free_slot(0)
    ref.free_slot(0)
    _host_state_equal(port, ref)
    assert port.can_admit(c) == ref.can_admit(c)
    _host_state_equal(port, ref)
    both("prepare_admission", 0, c)
    assert port.can_admit(c) == ref.can_admit(c) is False
    for s in (0, 1):
        port.free_slot(s)
        ref.free_slot(s)
    port.prefix.drop_all()
    ref.prefix.drop_all()
    _host_state_equal(port, ref)
    assert port.groups["L32"]["alloc"].live() == []
    port.scrape_gauges()
    snap = port._registry.snapshot()
    assert snap["pages_live"]["group=L32"] == 0 and snap["page_allocs_total"]["group=L32"] > 0
    assert port.report()["groups"]["L32"]["high_water"] == ref.report()["groups"]["L32"]["high_water"]


def test_paged_window_group_host_state_equals_reference():
    """gemma2: the local layers' 8-row window is its own group, whose whole
    window is attached at admission; rows past the window wrap."""
    port, ps, ref, rs = _pools("gemma2_2b", page_size=4)
    assert set(port.groups) == {"L8", "L32"}
    for s, prompt in ((0, list(range(1, 11))), (1, [5, 6, 7])):
        port.prepare_admission(ps, s, prompt)
        rs = ref.prepare_admission(rs, s, prompt)[0]
    for lo, hi in ((10, 13), (14, 19)):
        port.ensure_rows(ps, 0, lo, hi)
        rs = ref.ensure_rows(rs, 0, lo, hi)
    _host_state_equal(port, ref)
    port.free_slot(0)
    ref.free_slot(0)
    _host_state_equal(port, ref)


@pytest.mark.parametrize("arch", ["deepseek_7b", "gemma2_2b"])
def test_paged_write_read_roundtrip_equals_reference(arch):
    """``write`` scatters a slot into pages that equal the reference
    pool's (sink page skipped); ``read`` gives it back bit for bit; the
    other slot stays pristine; ``reset`` releases every page."""
    port, ps, ref, rs = _pools(arch, page_size=4)
    single = _random_tree(init_caches(smoke(arch), 1, 32, device="cpu"), 1)
    port.write(ps, single, 0)
    rs = ref.write(rs, {k: {n: jnp.asarray(v.numpy()) for n, v in node.items()}
                        for k, node in single.items()}, 0)
    _host_state_equal(port, ref)
    for key, node in ps["pages"].items():
        for name, arr in node.items():
            np.testing.assert_array_equal(arr[:, :-1].numpy(), np.asarray(rs["pages"][key][name]))
    assert _tree_equal(port.read(ps, 0), single)
    assert _tree_equal(port.read(ps, 1), init_caches(smoke(arch), 1, 32, device="cpu"))
    port.reset(ps, 0)
    for g in port.groups.values():
        assert g["alloc"].live() == [] and (g["table"] == 0).all()
    assert _tree_equal(port.read(ps, 0), init_caches(smoke(arch), 1, 32, device="cpu"))


def test_paged_empty_view_is_pristine_and_sink_is_never_read():
    cfg = smoke("gemma2_2b")
    pool = PagedCachePool(cfg, 2, 32, 4, device="cpu")
    state = pool.alloc()
    for gk, g in pool.groups.items():  # poison the sink pages
        for key in g["keys"]:
            for name, arr in state["pages"][key].items():
                arr[:, pool.sink(gk)] = 7
    pool.ensure_rows(state, 0, 0, 31)
    view = pool.device_view(state, pool.device_tables())
    assert _tree_equal(view, init_caches(cfg, 2, 32, device="cpu"))


def test_paged_commit_rows_masked_lane_untouched():
    """A masked lane's rows go to the sink page: its pages and the zero
    page keep their bits; the member lane's row lands at its position."""
    pool = PagedCachePool(smoke("deepseek_7b"), 2, 32, 8, device="cpu")
    state = pool.alloc()
    pool.ensure_rows(state, 0, 0, 0)
    pool.ensure_rows(state, 1, 0, 0)
    tables = pool.device_tables()
    view = pool.device_view(state, tables)
    poked = {k: {n: v + (1 if v.dtype == torch.int32 else 7) for n, v in node.items()}
             for k, node in view.items()}
    pos = torch.tensor([3, 3], dtype=torch.int32)
    pool.commit_rows(state, tables, poked, pos, torch.tensor([True, False]))
    after = pool.device_view(state, tables)
    for key, node in after.items():
        for name, leaf in node.items():
            assert torch.equal(leaf[:, 1], view[key][name][:, 1]), (key, name)
            assert torch.equal(leaf[:, 0, 3], poked[key][name][:, 0, 3]), (key, name)
            assert torch.equal(leaf[:, 0, 4:], view[key][name][:, 0, 4:]), (key, name)
            zero = state["pages"][key][name][:, 0]
            assert bool((zero == (-1 if name == "pos" else 0)).all())


def test_paged_copy_on_write():
    pool = PagedCachePool(smoke("deepseek_7b"), 2, 32, 8, device="cpu")
    state = pool.alloc()
    g = pool.groups["L32"]
    pool.write(state, _random_tree(init_caches(smoke("deepseek_7b"), 1, 32, device="cpu"), 2), 0)
    pid = int(g["table"][0, 0])
    g["alloc"].incref(pid)
    g["table"][1, 0] = pid
    pool._dirty = True
    before = pool.read(state, 0)["pos0"]["k"].clone()
    pool.ensure_rows(state, 1, 0, 7)
    new_pid = int(g["table"][1, 0])
    assert new_pid != pid and g["alloc"].refcount[pid] == 1 and g["alloc"].refcount[new_pid] == 1
    assert torch.equal(pool.read(state, 1)["pos0"]["k"][:, :, :8], before[:, :, :8])
    assert torch.equal(pool.read(state, 0)["pos0"]["k"], before)
    pool.ensure_rows(state, 1, 0, 7)
    assert int(g["table"][1, 0]) == new_pid  # exclusive pages do not re-copy


def test_paged_prepare_admission_with_sharing():
    pool = PagedCachePool(smoke("deepseek_7b"), 2, 32, 8, prefix_sharing=True, device="cpu")
    state = pool.alloc()
    _, matched, chain = pool.prepare_admission(state, 0, list(range(20)))
    assert matched == 0 and len(chain) == 2 and pool.finish_admission(0, chain, 0) == 2
    _, matched2, _ = pool.prepare_admission(state, 1, list(range(16)) + [99, 98, 97, 96])
    g = pool.groups["L32"]
    assert matched2 == 16 and (g["table"][1, :2] == g["table"][0, :2]).all()
    assert g["alloc"].refcount[g["table"][0, 0]] == 4 and g["alloc"].refcount[g["table"][0, 1]] == 3
    pool.free_slot(0)
    _, matched3, _ = pool.prepare_admission(state, 0, list(range(16)))
    assert matched3 == 8  # a page-aligned prompt never attaches its last page
    pool.free_slot(0)
    pool.free_slot(1)
    pool.prefix.drop_all()
    assert g["alloc"].live() == []


def test_paged_can_admit_pressure_and_eviction():
    pool = PagedCachePool(smoke("deepseek_7b"), 2, 32, 8, n_pages=5, prefix_sharing=True,
                          device="cpu")
    state = pool.alloc()
    g = pool.groups["L32"]
    _, m, chain = pool.prepare_admission(state, 0, list(range(20)))
    pool.finish_admission(0, chain, m)
    pool.free_slot(0)
    assert len(pool.prefix) == 2 and len(g["alloc"].live()) == 2
    assert pool.can_admit(list(range(100, 120))) and g["alloc"].n_free >= 3
    _, m, chain = pool.prepare_admission(state, 0, list(range(200, 220)))
    pool.finish_admission(0, chain, m)
    assert not pool.can_admit(list(range(300, 320)))


def test_paged_rejections():
    with pytest.raises(ValueError, match="prefix_sharing"):
        PagedCachePool(smoke("gemma2_2b"), 2, 32, 4, prefix_sharing=True, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        PagedCachePool(smoke("gemma2_2b"), 2, 64, 32, device="cpu")  # window 8
