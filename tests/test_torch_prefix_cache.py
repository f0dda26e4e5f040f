"""Port parity: the radix prefix cache and the engine's copy-on-write pages.

The port's `RadixPrefixCache` is a copy of the reference's, so scripted
operations must give equal results through both. The engines must agree
step by step on a scripted request sequence with the prefix cache on
(`tiny` in f32 on the CPU, the reference's weights through
`weights.from_jax_params`): greedy tokens exactly, matched tokens, every
slot's page list and shared set, and the free list in order, so the two
page pools never drift apart. The rest mirrors the reference's own cases
(tests/unit/test_prefix_cache.py) on the port engine, with the port's
host counters (`engine.stats`) in place of the reference's instruments.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import prefix_cache as ref_prefix
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.observability import instruments as obs
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import prefix_cache as port_prefix


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params))
    return ref_config, params, config, tparams


def _greedy(max_new):
    return inference.SamplingParams(temperature=0.0, max_new_tokens=max_new)


def _engine(tparams, config, **kw):
    kw.setdefault('batch_size', 2)
    kw.setdefault('max_seq_len', 128)
    kw.setdefault('kv_page_size', 8)
    kw.setdefault('kv_quant', 'none')
    return inference.InferenceEngine(tparams, config, device='cpu', **kw)


# -- the radix tree: the same operations through both copies -----------------


def _script(rng, n_ops=60, page=4):
    """Seeded random operations over a few token families that share
    prefixes, so matches split edges and publishes collide."""
    bases = [list(rng.integers(1, 50, size=24)) for _ in range(3)]
    next_page = [1]
    ops = []
    for _ in range(n_ops):
        base = bases[rng.integers(len(bases))]
        cut = int(rng.integers(0, 24))
        toks = [int(t) for t in base[:cut]] + [
            int(t) for t in rng.integers(1, 50, size=int(rng.integers(0, 9)))]
        kind = rng.choice(['match', 'insert', 'insert', 'acquire',
                           'release', 'evict', 'clear'],
                          p=[.3, .2, .2, .1, .1, .08, .02])
        if kind == 'insert':
            n = len(toks) // page
            ids = list(range(next_page[0], next_page[0] + n))
            next_page[0] += n
            ops.append(('insert', toks, ids))
        elif kind == 'evict':
            ops.append(('evict', int(rng.integers(1, 6))))
        else:
            ops.append((str(kind), toks))
    return ops


def _run_script(cache_mod, ops, page=4):
    t = cache_mod.RadixPrefixCache(page)
    held = []
    out = []
    for op in ops:
        if op[0] == 'match':
            m = t.match(op[1])
            out.append(('match', m.pages, m.tokens))
        elif op[0] == 'insert':
            out.append(('insert', t.insert(op[1], op[2])))
        elif op[0] == 'acquire':
            m = t.match(op[1])
            t.acquire(m.pages)
            held.append(m.pages)
            out.append(('acquire', m.pages))
        elif op[0] == 'release':
            if held:
                t.release(held.pop(0))
            out.append(('release',))
        elif op[0] == 'evict':
            out.append(('evict', t.evict_lru(op[1])))
        else:
            out.append(('clear', t.clear()))
        out.append(('state', t.num_pages(),
                    sorted((p, t.refcount(p)) for p in range(1, 200)
                           if t.owns(p) or t.refcount(p))))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_radix_cache_scripted_operations_match_reference(seed):
    ops = _script(np.random.default_rng(seed))
    assert _run_script(port_prefix, ops) == _run_script(ref_prefix, ops)


def test_radix_cache_named_operations_match_reference():
    """match, insert with split and branch, duplicate publish,
    acquire/release, evict_lru and clear, in that order."""
    got = []
    for mod in (ref_prefix, port_prefix):
        t = mod.RadixPrefixCache(4)
        rec = [t.insert(list(range(12)), [1, 2, 3])]
        m = t.match(list(range(8)) + [50] * 4)          # split at page 2
        rec.append((m.pages, m.tokens))
        rec.append(t.insert(list(range(8)) + [50] * 8, [1, 2, 7, 8]))
        rec.append(t.insert(list(range(12)), [1, 9, 3]))  # duplicate
        t.acquire([1, 2])
        rec.append(t.evict_lru(100))
        t.release([1, 2])
        t.acquire([1])
        rec.append(t.clear())
        rec.append((t.num_pages(), t.owns(1), t.refcount(1)))
        got.append(rec)
    assert got[0] == got[1]
    assert got[1][2] == [] and got[1][3] == [9]


# -- the engines, step by step -----------------------------------------------

SCRIPT_CONFIGS = {
    # The default pool (2 slots x 16 pages).
    'default': dict(),
    # 10 pages: admissions wait for pages and reclaim cached ones.
    'oversubscribed': dict(kv_pages=10),
    # The radix index held at 4 pages after every publish.
    'capped': dict(prefix_cache_max_pages=4),
    'int8': dict(kv_quant='int8'),
}


@pytest.mark.parametrize('name', list(SCRIPT_CONFIGS))
def test_engine_matches_reference_step_by_step(tiny, name):
    """A shared prefix, a partial match, a full-prompt match (COW of the
    last page at admission), a COW forced on a decode write, an abort
    mid-prefill and cold requests that press on the pool: after every
    step the two engines hold the same tokens, matched tokens, page
    lists, shared sets and free list."""
    ref_config, params, config, tparams = tiny
    kw = {**dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, kv_quant='none', decode_fuse_steps=2,
                 prefix_cache=True), **SCRIPT_CONFIGS[name]}
    ref = ref_inference.InferenceEngine(params, ref_config, **kw)
    port = inference.InferenceEngine(tparams, config, device='cpu', **kw)
    done_ref, done_port = {}, {}

    def compare():
        assert port._page_alloc == ref._page_alloc
        assert port._slot_pages == ref._slot_pages
        assert port._slot_shared == ref._slot_shared
        assert port.pages_free() == len(ref._page_alloc)
        assert port.pages_cached() == ref._prefix.num_pages()
        assert port.active_progress() == ref.active_progress()
        assert done_port == done_ref

    def step():
        reused = obs.PREFIX_CACHE_REUSED_TOKENS.value()
        port_reused = port.stats['prefix_reused_tokens']
        ref.step()
        port.step()
        assert (port.stats['prefix_reused_tokens'] - port_reused
                == obs.PREFIX_CACHE_REUSED_TOKENS.value() - reused)
        done_ref.update(ref.finished())
        done_port.update(port.finished())
        compare()

    def run():
        while ref.has_work or port.has_work:
            step()

    def submit(prompt, max_new):
        rid = ref.submit(prompt, ref_inference.SamplingParams(
            max_new_tokens=max_new))
        assert port.submit(prompt, _greedy(max_new)) == rid
        return rid

    prefix = [i % 97 + 1 for i in range(40)]
    submit(prefix + [7, 8], 6)
    run()
    submit(prefix + [9, 10, 11], 6)          # 40 tokens matched
    submit(prefix[:24] + [50] * 5, 6)        # 24 tokens matched
    run()
    full = [i % 89 + 1 for i in range(48)]   # 6 full pages
    submit(full, 4)
    run()
    submit(full, 4)                          # full match: COW last page
    run()
    rid = submit(prefix + [9], 20)
    step()
    step()
    i = next(i for i, s in enumerate(port.state.slots)
             if s is not None and s.request_id == rid)
    if port._slot_shared[i]:
        idx = min(port._slot_shared[i])
        ref._cow_guard(i, idx * 8, idx * 8)
        port._cow_guard(i, idx * 8, idx * 8)
        compare()
    run()
    ghost = submit(prefix[:16] + list(range(60, 100)), 4)
    step()
    assert any(s is not None and s.pending is not None
               for s in port.state.slots)
    ref.abort(ghost)
    port.abort(ghost)
    compare()
    run()
    submit(list(range(2, 50)), 8)
    submit(list(range(3, 60)), 4)
    run()
    assert sorted(done_port) == [r for r in range(ghost + 3) if r != ghost]
    assert port.pages_free() + port.pages_cached() == port.pages_total()
    assert port.stats['prefix_hits'] >= 4


# -- mirrored reference cases: hits, equivalence, COW ------------------------


def test_warm_request_hits_and_reuses_tokens(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    prefix = [i % 97 + 1 for i in range(40)]
    eng.submit(prefix + [7, 8], _greedy(6))
    eng.run_to_completion()
    assert eng.stats['prefix_hits'] == 0 and eng.stats['prefix_misses'] == 1
    eng.submit(prefix + [9, 10, 11], _greedy(6))
    eng.run_to_completion()
    assert eng.stats['prefix_hits'] == 1
    # 40 prefix tokens = 5 full pages skipped by prefill.
    assert eng.stats['prefix_reused_tokens'] == 40


def test_greedy_equivalence_cache_on_vs_off(tiny):
    _, _, config, tparams = tiny
    prefix = [i % 97 + 1 for i in range(40)]
    tails = ([7, 8], [9, 10, 11], [12], [9, 10, 99])
    on = _engine(tparams, config)
    got = {}
    for tail in tails:
        rid = on.submit(prefix + list(tail), _greedy(6))
        got[tuple(tail)] = on.run_to_completion()[rid]
    assert on.stats['prefix_hits'] == 3
    off = _engine(tparams, config, prefix_cache=False)
    for tail in tails:
        rid = off.submit(prefix + list(tail), _greedy(6))
        assert off.run_to_completion()[rid] == got[tuple(tail)], tail


def test_full_prompt_match_cows_last_page(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    prompt = [i % 89 + 1 for i in range(48)]
    r1 = eng.submit(list(prompt), _greedy(4))
    out1 = eng.run_to_completion()[r1]
    cached_before = eng.pages_cached()
    r2 = eng.submit(list(prompt), _greedy(4))
    assert eng.run_to_completion()[r2] == out1
    assert eng.stats['prefix_hits'] == 1 and eng.stats['cow_copies'] == 1
    r3 = eng.submit(list(prompt), _greedy(4))
    assert eng.run_to_completion()[r3] == out1
    assert eng.pages_cached() >= cached_before
    off = _engine(tparams, config, prefix_cache=False)
    r4 = off.submit(list(prompt), _greedy(4))
    assert off.run_to_completion()[r4] == out1


def test_cow_on_decode_write_copies_shared_page(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    prefix = [i % 97 + 1 for i in range(40)]
    eng.submit(prefix + [7, 8], _greedy(6))
    eng.run_to_completion()
    rid = eng.submit(prefix + [9], _greedy(20))
    eng.step()
    eng.step()
    i = next(i for i, s in enumerate(eng.state.slots)
             if s is not None and s.request_id == rid)
    shared = set(eng._slot_shared[i])
    assert shared
    idx = min(shared)
    src = eng._slot_pages[i][idx]
    assert eng._prefix.refcount(src) == 1
    k_before = eng.state.cache['k'][:, src].clone()
    eng._cow_guard(i, idx * eng.kv_page_size, idx * eng.kv_page_size)
    assert idx not in eng._slot_shared[i]
    dst = eng._slot_pages[i][idx]
    assert dst != src and eng._prefix.refcount(src) == 0
    assert torch.equal(eng.state.cache['k'][:, src], k_before)
    assert torch.equal(eng.state.cache['k'][:, dst], k_before)
    out = eng.run_to_completion()[rid]
    off = _engine(tparams, config, prefix_cache=False)
    r2 = off.submit(prefix + [9], _greedy(20))
    assert off.run_to_completion()[r2] == out


def test_two_long_warm_tails_leave_shared_pages_intact(tiny):
    """Two warm requests whose tails exceed prefill_chunk are admitted in
    one step while a third slot decodes. Only one long chunk runs per
    step, so the second warm slot sits out that decode round with its
    table row already mapping the shared pages; its masked decode write
    must land at its resume point, in a private page, and never in the
    radix cache's pages."""
    _, _, config, tparams = tiny
    prefix = [i % 97 + 1 for i in range(40)]
    tails = ([60 + j for j in range(20)], [80 + j for j in range(24)])

    def serve(eng, check):
        eng.submit(prefix + [7], _greedy(2))
        eng.run_to_completion()
        shared = eng._prefix.match(prefix).pages if check else []
        before = {k: eng.state.cache[k][:, shared].clone()
                  for k in ('k', 'v')}
        decoding = eng.submit([5, 6, 7], _greedy(24))
        eng.step()
        rids = [eng.submit(prefix + t, _greedy(6)) for t in tails]
        eng.step()
        if check:
            warm = [s for s in eng.state.slots
                    if s is not None and s.request_id in rids]
            # Both admitted at the match; one ran its long chunk.
            assert len(warm) == 2
            assert sorted(s.pos for s in warm) == [40, 56]
            assert eng.stats['prefix_reused_tokens'] == 80
        out = eng.run_to_completion()
        for k in ('k', 'v'):
            assert torch.equal(eng.state.cache[k][:, shared], before[k])
        return [out[r] for r in rids + [decoding]]

    kw = dict(batch_size=3, prefill_chunk=16)
    on = serve(_engine(tparams, config, **kw), True)
    off = serve(_engine(tparams, config, prefix_cache=False, **kw), False)
    assert on == off


def test_sampled_requests_publish_real_token_sequence(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config, seed=3)
    prefix = [i % 97 + 1 for i in range(40)]
    eng.submit(prefix + [7], inference.SamplingParams(
        temperature=0.9, top_k=8, max_new_tokens=8))
    eng.run_to_completion()
    rid = eng.submit(prefix + [7, 9, 9], _greedy(5))
    out = eng.run_to_completion()[rid]
    off = _engine(tparams, config, prefix_cache=False)
    r2 = off.submit(prefix + [7, 9, 9], _greedy(5))
    assert off.run_to_completion()[r2] == out


# -- eviction and oversubscription -------------------------------------------


def test_oversubscribed_pool_reclaims_lru_pages(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config, max_seq_len=64, kv_pages=5)
    eng.submit(list(range(2, 20)), _greedy(4))
    eng.run_to_completion()
    assert eng.pages_cached() > 0
    r2 = eng.submit(list(range(3, 30)), _greedy(4))
    out = eng.run_to_completion()
    assert r2 in out and len(out[r2]) == 4
    assert eng.stats['prefix_evictions'] > 0
    assert eng.pages_free() + eng.pages_cached() == eng.pages_total()


def test_refcounted_pages_never_reclaimed(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config, max_seq_len=64, kv_pages=8)
    prefix = [i % 97 + 1 for i in range(16)]
    eng.submit(prefix + [5], _greedy(4))
    eng.run_to_completion()
    rid = eng.submit(prefix + [6], _greedy(12))
    eng.step()
    i = next(i for i, s in enumerate(eng.state.slots) if s is not None)
    pinned = [eng._slot_pages[i][j] for j in sorted(eng._slot_shared[i])]
    assert pinned and all(eng._prefix.refcount(p) == 1 for p in pinned)
    r3 = eng.submit(list(range(2, 30)), _greedy(4))
    out = eng.run_to_completion()
    assert rid in out and r3 in out
    off = _engine(tparams, config, max_seq_len=64, prefix_cache=False)
    ra = off.submit(prefix + [6], _greedy(12))
    assert off.run_to_completion()[ra] == out[rid]


def test_max_pages_cap_trims_lru_tail(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config, prefix_cache_max_pages=3)
    pre = [i % 53 + 1 for i in range(40)]
    eng.submit(list(pre), _greedy(4))
    eng.run_to_completion()
    assert eng.pages_cached() == 3
    assert eng._prefix.match(pre).tokens == 24


def test_abort_releases_pins_without_publishing(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    prefix = [i % 97 + 1 for i in range(40)]
    eng.submit(prefix + [7], _greedy(4))
    eng.run_to_completion()
    cached = eng.pages_cached()
    ghost = eng.submit(prefix + [8], _greedy(50))
    eng.step()
    eng.abort(ghost)
    assert eng.pages_cached() == cached
    assert eng.pages_free() + eng.pages_cached() == eng.pages_total()
    rid = eng.submit(prefix + [7], _greedy(4))
    assert len(eng.run_to_completion()[rid]) == 4


def test_abort_all_clears_the_cache(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    eng.submit([i % 97 + 1 for i in range(40)], _greedy(4))
    eng.run_to_completion()
    eng.submit([i % 97 + 1 for i in range(40)] + [3], _greedy(30))
    eng.step()
    eng.abort_all()
    assert eng.pages_cached() == 0 and not eng.has_work
    assert eng.pages_free() == eng.pages_total()


def test_page_pool_composition(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config)
    prefix = [i % 97 + 1 for i in range(40)]
    eng.submit(prefix + [7], _greedy(4))
    eng.run_to_completion()
    assert eng.pages_cached() > 0
    assert eng.pages_free() + eng.pages_cached() == eng.pages_total()
    eng.submit(prefix + [8], _greedy(30))
    eng.step()
    private = eng.pages_total() - eng.pages_free() - eng.pages_cached()
    assert private > 0
    eng.run_to_completion()


def test_disabled_engine_counts_nothing(tiny):
    _, _, config, tparams = tiny
    eng = _engine(tparams, config, prefix_cache=False)
    eng.submit([i % 97 + 1 for i in range(40)], _greedy(4))
    eng.run_to_completion()
    assert eng._prefix is None
    assert eng.stats['prefix_hits'] == eng.stats['prefix_misses'] == 0
    assert eng.pages_free() == eng.pages_total()
