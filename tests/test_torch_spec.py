"""Port parity: speculative decode (draft cache, fused draft/verify rounds)
against the JAX engine.

Both packages run the `tiny` config in f32 on the CPU with the same
weights (reference `init_params` -> numpy -> `weights.from_jax_params`).
`fused_spec_rounds` gets the same prefilled caches in both: tokens,
emitted counts, last tokens, rounds, proposed and accepted counts and
both caches' lengths must be equal, logprobs within 1e-4. Engines with a
draft give the JAX spec engine's greedy tokens and the port's plain
greedy tokens exactly. Every JAX function is compiled once per module
(one `(k, n_rounds)` for the function cases).
"""
import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import engine as ref_eng
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu_torch import inference as port_inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import spec_fault_check  # noqa: E402

K, ROUNDS = 3, 4
PROMPTS = [list(range(3, 14)), list(range(40, 46))]
BATCH, SEQ, PAGE = 3, 64, 8        # slot 2 stays empty and inactive


def _pair(ref_config, key):
    params = ref_llama.init_params(ref_config, jax.random.key(key))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params))
    return params, tparams


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The tiny f32 engines gain nothing from intra-op threads, and the
    suite runs in several worker processes on few cores: one thread keeps
    this module from crowding the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def models():
    """Target (key 7), the same-architecture adversarial draft (key 99)
    and a smaller draft architecture (the reference's
    test_small_draft_architecture shape, key 5), each as (reference
    config, reference params, port config, port params)."""
    ref_config = ref_llama.CONFIGS['tiny']
    small = dataclasses.replace(ref_config, num_layers=1, hidden_size=32,
                                intermediate_size=64, num_heads=2,
                                num_kv_heads=1, head_dim=16)
    out = {}
    for name, cfg, key in (('target', ref_config, 7),
                           ('adversarial', ref_config, 99),
                           ('small', small, 5)):
        params, tparams = _pair(cfg, key)
        out[name] = (cfg, params,
                     weights.config_from_dict(dataclasses.asdict(cfg)),
                     tparams)
    return out


# -- fused_spec_rounds ------------------------------------------------------


def _prefilled(ref_config, params, config, tparams):
    """The same paged cache in both packages, PROMPTS prefilled into
    slots 0 and 1 (each slot owns its pages); plus the last-token
    logits' argmax."""
    w = SEQ // PAGE
    table = np.zeros((BATCH, w), np.int32)
    table[:2] = np.arange(1, 1 + 2 * w).reshape(2, w)
    padded = np.array([p + [0] * (16 - len(p)) for p in PROMPTS], np.int32)
    lengths = np.array([len(p) for p in PROMPTS], np.int32)
    ref_cache = ref_eng.init_cache(ref_config, BATCH, SEQ, page_size=PAGE)
    ref_cache['table'] = jnp.asarray(table)
    logits, ref_cache = ref_eng.prefill_chunked(
        params, jnp.asarray(padded), jnp.asarray(lengths), ref_cache,
        jnp.arange(2, dtype=jnp.int32), ref_config, chunk=16)
    cache = port_eng.init_cache(config, BATCH, SEQ, page_size=PAGE,
                                device='cpu')
    cache['table'] = torch.from_numpy(table)
    port_logits, _ = port_eng.prefill_chunked(
        tparams, torch.from_numpy(padded).long(), torch.from_numpy(lengths),
        cache, torch.arange(2), config, chunk=16)
    last = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(port_logits.argmax(-1).numpy(), last)
    return ref_cache, cache, last


def _spec_both(models, draft, eos=(-1, -1, -1), budgets=(30, 30, 0),
               max_len=SEQ - 2, slab_cap=SEQ, fn=None):
    """fused_spec_rounds of both packages on the same inputs; `fn`
    replaces the port's function (a planted fault)."""
    ref_config, params, config, tparams = models['target']
    d_ref_config, dparams, d_config, d_tparams = models[draft]
    ref_cache, cache, last = _prefilled(ref_config, params, config, tparams)
    ref_dcache, dcache, _ = _prefilled(d_ref_config, dparams, d_config,
                                       d_tparams)
    last = np.concatenate([last, [0]]).astype(np.int32)
    active = np.array([True, True, False])
    eos = np.asarray(eos, np.int32)
    budgets = np.asarray(budgets, np.int32)
    want = ref_eng.fused_spec_rounds(
        params, ref_cache, dparams, ref_dcache, jnp.asarray(last),
        jnp.asarray(active), jnp.asarray(eos), jnp.asarray(budgets),
        jnp.int32(max_len), jnp.int32(slab_cap), config=ref_config,
        draft_config=d_ref_config, k=K, n_rounds=ROUNDS)
    got = (fn or port_eng.fused_spec_rounds)(
        tparams, cache, d_tparams, dcache, torch.from_numpy(last),
        torch.from_numpy(active), torch.from_numpy(eos),
        torch.from_numpy(budgets), max_len, slab_cap, config, d_config, K,
        ROUNDS)
    return got, jax.device_get(want)


def _assert_spec_equal(got, want):
    (toks, lps, emitted, last, rounds, proposed, accepted, cache,
     dcache) = got
    (w_toks, w_lps, w_emitted, w_last, w_rounds, w_proposed, w_accepted,
     w_cache, w_dcache) = want
    np.testing.assert_array_equal(emitted.numpy(), w_emitted)
    for b, n in enumerate(w_emitted):
        np.testing.assert_array_equal(toks.numpy()[b, :n], w_toks[b, :n])
        np.testing.assert_allclose(lps.numpy()[b, :n], w_lps[b, :n],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(last.numpy(), w_last)
    assert rounds == int(w_rounds)
    assert int(proposed) == int(w_proposed)
    np.testing.assert_array_equal(accepted.numpy(), w_accepted)
    np.testing.assert_array_equal(cache['length'].numpy(),
                                  w_cache['length'])
    np.testing.assert_array_equal(dcache['length'].numpy(),
                                  w_dcache['length'])


def _greedy_tokens(models, n):
    """The target's greedy continuation of each prompt (port, plain)."""
    _, _, config, tparams = models['target']
    engine = port_inference.InferenceEngine(
        tparams, config, batch_size=2, max_seq_len=SEQ, kv_page_size=PAGE,
        prefill_chunk=16, device='cpu')
    rids = [engine.submit(p, port_eng.SamplingParams(max_new_tokens=n))
            for p in PROMPTS]
    out = engine.run_to_completion()
    return [out[r] for r in rids]


@pytest.mark.parametrize('case', ['draft_is_target', 'adversarial', 'small',
                                  'eos_mid_burst', 'budget', 'slab_bound'])
def test_fused_spec_rounds_matches_reference(models, case):
    kw = {}
    draft = {'draft_is_target': 'target', 'small': 'small'}.get(
        case, 'adversarial')
    if case == 'eos_mid_burst':
        # Slot 0's 5th decode token is its eos (a draft=target burst
        # would emit it inside round 2 of 3 tokens).
        draft = 'target'
        eos_tok = _greedy_tokens(models, 8)[0][5]
        kw['eos'] = (eos_tok, -1, -1)
    elif case == 'budget':
        draft = 'target'
        kw['budgets'] = (5, 7, 0)       # neither a multiple of k
    elif case == 'slab_bound':
        # Slot 0 starts at 11: after two full rounds (17) its next slab
        # (17 + 3 = 20) passes the cap, so the whole batch stops there.
        draft = 'target'
        kw['slab_cap'] = 19
    got, want = _spec_both(models, draft, **kw)
    _assert_spec_equal(got, want)
    emitted = got[2].tolist()
    if case == 'draft_is_target':
        assert got[4] == ROUNDS and emitted[:2] == [ROUNDS * K] * 2
        assert got[6][:2].min() == K          # every proposal accepted
    elif case == 'adversarial':
        assert 0 <= got[6][:2].max() < K      # misses, still lossless
    elif case == 'eos_mid_burst':
        assert emitted[0] == 5 and int(got[0][0, 4]) == kw['eos'][0]
    elif case == 'budget':
        assert emitted[:2] == [5, 7]
    elif case == 'slab_bound':
        assert got[4] == 2 and emitted[:2] == [2 * K] * 2
    if case in ('draft_is_target', 'adversarial', 'small'):
        want_tokens = _greedy_tokens(models, 1 + ROUNDS * K)
        for b in range(2):
            n = emitted[b]
            assert got[0][b, :n].tolist() == want_tokens[b][1:1 + n]


def planted_engine(fault):
    """The port's engine module with one of spec_fault_check.py's faults
    planted in its source (the faults chip_smoke's limits are held to)."""
    with open(port_eng.__file__) as f:
        source = f.read()
    module = types.ModuleType('planted_engine')
    # The engine's dataclasses resolve their annotations through
    # sys.modules while the source runs.
    sys.modules[module.__name__] = module
    try:
        exec(compile(spec_fault_check.plant(source, fault), port_eng.__file__,
                     'exec'), module.__dict__)
    finally:
        del sys.modules[module.__name__]
    return module


@pytest.mark.parametrize('fault', ['emit_drafted_on_miss',
                                   'target_length_not_rolled_back',
                                   'draft_length_not_rolled_back'])
def test_planted_spec_faults_break_parity(models, fault):
    """The parity check catches a wrong round: m+1 drafted tokens emitted
    on a miss (no correction), or either cache's length left at L+k. The
    draft's stays lossless, so only the counts and lengths show it."""
    fn = planted_engine(fault).fused_spec_rounds
    got, want = _spec_both(models, 'small', fn=fn)
    with pytest.raises(AssertionError):
        _assert_spec_equal(got, want)


# -- engines ------------------------------------------------------------------

REQUESTS = [(list(range(3, 8)), 17), (list(range(30, 52)), 17),
            (list(range(60, 69)), 5), (list(range(100, 140)), 17)]
ENGINE_KW = dict(batch_size=3, max_seq_len=SEQ, prefill_chunk=16)
LAYOUTS = {'dense': dict(kv_page_size=0, kv_quant='none'),
           'paged': dict(kv_page_size=8, kv_quant='none'),
           'int8_paged': dict(kv_page_size=8, kv_quant='int8'),
           # 8 pages of 8 for requests of up to 8 pages each: the queue
           # waits on the pool.
           'oversubscribed': dict(kv_page_size=8, kv_quant='none',
                                  kv_pages=8)}
# The layouts also run through the JAX spec engine: dense and paged, bf16
# and int8 between them (paged bf16 meets the JAX function above).
REF_LAYOUTS = ('dense', 'int8_paged')


def _drain(engine, sampling_cls, eos=None):
    rids = [engine.submit(p, sampling_cls(max_new_tokens=n,
                                          eos_token_id=eos if i == 0
                                          else None))
            for i, (p, n) in enumerate(REQUESTS)]
    out = engine.run_to_completion()
    lps = engine.finished_logprobs()
    return [out[r] for r in rids], lps


@pytest.fixture(scope='module')
def ref_spec_runs(models):
    ref_config, params, _, _ = models['target']
    _, dparams, _, _ = models['adversarial']
    runs = {}
    for name in REF_LAYOUTS:
        layout = LAYOUTS[name]
        engine = ref_inference.InferenceEngine(
            params, ref_config, draft=(dparams, ref_config), spec_k=K,
            spec_fuse_rounds=ROUNDS, **ENGINE_KW, **layout)
        runs[name] = _drain(engine, ref_inference.SamplingParams)[0]
    return runs


def _port_engine(models, layout, draft='adversarial', **kw):
    _, _, config, tparams = models['target']
    if draft is not None:
        _, _, d_config, d_tparams = models[draft]
        kw.update(draft=(d_tparams, d_config), spec_k=K,
                  spec_fuse_rounds=ROUNDS)
    return port_inference.InferenceEngine(tparams, config, device='cpu',
                                          **ENGINE_KW, **LAYOUTS[layout],
                                          **kw)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_spec_engine_matches_reference_and_plain(models, ref_spec_runs,
                                                 layout):
    engine = _port_engine(models, layout)
    tokens, _ = _drain(engine, port_eng.SamplingParams)
    if layout in ref_spec_runs:
        assert tokens == ref_spec_runs[layout]
    plain, _ = _drain(_port_engine(models, layout, draft=None),
                      port_eng.SamplingParams)
    assert tokens == plain
    assert [len(t) for t in tokens] == [n for _, n in REQUESTS]
    st = engine.stats
    assert st['spec_rounds'] > 0 and st['spec_proposed_tokens'] > 0
    assert sum(st['spec_accepted_per_round']) * K == \
        st['spec_proposed_tokens']
    if layout == 'oversubscribed':
        assert engine.pages_free() == engine.pages_total()
        engine = _port_engine(models, layout)
        for prompt, n in REQUESTS[:2]:
            engine.submit(prompt, port_eng.SamplingParams(max_new_tokens=n))
        engine.step()           # 4 of 8 pages held: the 6-page one waits
        assert engine.queue_depth() == 1


def test_draft_is_target_accepts_every_proposal(models):
    """The pairing check: a draft that is the target itself (one params
    object) accepts everything it proposes inside the budget, and the
    logprobs are plain greedy's."""
    _, _, config, tparams = models['target']
    engine = port_inference.InferenceEngine(
        tparams, config, draft=(tparams, config), spec_k=4,
        spec_fuse_rounds=8, batch_size=2, max_seq_len=SEQ, device='cpu')
    assert engine._draft_params['embed'] is engine.params['embed']
    rid = engine.submit([3, 17, 42, 9, 105, 8],
                        port_eng.SamplingParams(max_new_tokens=33))
    out = engine.run_to_completion()[rid]
    lps = engine.finished_logprobs()[rid]
    st = engine.stats
    # 1 prefill token + 32 decode tokens = 8 rounds of 4 in ONE dispatch.
    assert len(out) == 33 and st['spec_dispatches'] == 1
    assert st['spec_rounds'] == 8
    assert st['spec_accepted_tokens'] == st['spec_proposed_tokens'] == 32
    assert st['spec_accepted_per_round'] == [0, 0, 0, 0, 8]
    plain = port_inference.InferenceEngine(tparams, config, batch_size=2,
                                           max_seq_len=SEQ, device='cpu')
    rid = plain.submit([3, 17, 42, 9, 105, 8],
                       port_eng.SamplingParams(max_new_tokens=33))
    assert plain.run_to_completion()[rid] == out
    np.testing.assert_allclose(plain.finished_logprobs()[rid], lps,
                               atol=1e-4)


def test_eos_inside_a_round_stops_like_plain(models):
    _, _, config, tparams = models['target']
    prompt = [3, 17, 42]
    want = _plain_greedy(tparams, config, prompt, 12)
    eos = want[2]
    engine = port_inference.InferenceEngine(
        tparams, config, draft=(tparams, config), spec_k=4,
        spec_fuse_rounds=8, batch_size=2, max_seq_len=SEQ, device='cpu')
    rid = engine.submit(prompt, port_eng.SamplingParams(
        max_new_tokens=12, eos_token_id=eos))
    assert engine.run_to_completion()[rid] == want[:3]


def _plain_greedy(tparams, config, prompt, n, **kw):
    engine = port_inference.InferenceEngine(
        tparams, config, device='cpu',
        **{'batch_size': 2, 'max_seq_len': SEQ, **kw})
    rid = engine.submit(prompt, port_eng.SamplingParams(max_new_tokens=n))
    return engine.run_to_completion()[rid]


def test_near_capacity_falls_back_to_plain_decode(models):
    """A slot whose verify slab no longer fits sends the step down the
    plain fused-decode path (decided from host bookkeeping); the output
    matches host-stepped decode (paged). The adversarial draft emits
    about one token a round, so the slot reaches length 29, where the
    4-wide slab passes the 32-position capacity before the cache-full
    bound (30) ends the request."""
    _, _, config, tparams = models['target']
    _, _, d_config, d_tparams = models['adversarial']
    prompt = [int(i % 251) + 1 for i in range(20)]
    kw = dict(batch_size=1, max_seq_len=32, kv_page_size=8,
              kv_quant='none')
    host = _plain_greedy(tparams, config, prompt, 50, decode_fuse_steps=1,
                         **kw)
    engine = port_inference.InferenceEngine(
        tparams, config, draft=(d_tparams, d_config), spec_k=4,
        spec_fuse_rounds=4, device='cpu', **kw)
    rid = engine.submit(prompt, port_eng.SamplingParams(max_new_tokens=50))
    assert engine.run_to_completion()[rid] == host
    st = engine.stats
    assert 0 < st['spec_dispatches'] < st['decode_dispatches']


def test_dense_slab_parked_slot_output_uncorrupted(models):
    """On a dense cache a slot near the end must not take clamped k-wide
    writes while another slot keeps the burst going: the slab bound ends
    the burst for the whole batch. Tokens and logprobs as host-stepped
    decode."""
    _, _, config, tparams = models['target']
    _, _, d_config, d_tparams = models['adversarial']
    prompts = [[int(i % 251) + 1 for i in range(20)], [5, 6]]

    def run(**kw):
        engine = port_inference.InferenceEngine(
            tparams, config, batch_size=2, max_seq_len=32, kv_page_size=0,
            kv_quant='none', device='cpu', **kw)
        rids = [engine.submit(p, port_eng.SamplingParams(max_new_tokens=50))
                for p in prompts]
        out, lps = {}, {}
        while engine.has_work:
            engine.step()
            done = engine.finished()
            if done:
                out.update(done)
                lps.update(engine.finished_logprobs())
        return [out[r] for r in rids], [lps[r] for r in rids]

    host, host_lps = run(decode_fuse_steps=1)
    spec, spec_lps = run(draft=(d_tparams, d_config), spec_k=4,
                         spec_fuse_rounds=8)
    assert spec == host
    for got, want in zip(spec_lps, host_lps):
        np.testing.assert_allclose(got, want, atol=1e-3)


# -- gating -------------------------------------------------------------------


def test_draft_gating(models):
    _, _, config, tparams = models['target']
    other_vocab = dataclasses.replace(config, vocab_size=128)
    for kw, match in ((dict(draft=(tparams, other_vocab)), 'share the vocab'),
                      (dict(draft=(tparams, config), spec_k=0), 'spec_k'),
                      (dict(draft=(tparams, config), prefill_interleave=32),
                       'prefill_interleave')):
        with pytest.raises(ValueError, match=match):
            port_inference.InferenceEngine(tparams, config, device='cpu',
                                           **kw)
    # A draft serves under every axis (tests/test_torch_sharded_serving.py,
    # tests/test_torch_context_serving.py); an explicit page size with a
    # context axis still raises, with a draft too.
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    with pytest.raises(ValueError, match='context-sharded cache'):
        port_inference.InferenceEngine(
            tparams, config, device='cpu', draft=(tparams, config),
            kv_page_size=8,
            mesh=mesh_lib.Mesh(mesh_lib.MeshSpec(fsdp=1, context=2), 0, 2,
                               torch.device('cpu')))
    engine = port_inference.InferenceEngine(
        tparams, config, draft=(tparams, config), prefix_cache=True,
        prefill_chunk=16, max_seq_len=SEQ, kv_page_size=8, device='cpu')
    # A draft turns the prefix cache and interleaved prefill off, and
    # takes the knobs' defaults.
    assert engine._prefix is None and engine.prefill_interleave == 0
    assert (engine.spec_k, engine.spec_fuse_rounds) == (4, 8)
    assert engine.state.draft_cache is not None
    # The verify slab: prompt 12 + budget 4 fits two pages of 8 exactly,
    # and the 4-wide slab needs a third.
    assert engine._pages_needed(12, 4) == 3
    plain = port_inference.InferenceEngine(
        tparams, config, max_seq_len=SEQ, kv_page_size=8, device='cpu')
    assert plain._pages_needed(12, 4) == 2 and plain.state.draft_cache is None


def test_draft_cache_pairs_with_the_main_cache(models):
    """The draft cache has the main cache's page geometry (pool size read
    from the int8 leaf), stays bf16/f32 under an int8 main cache, and both
    table rows and lengths move together on admission and free; handoff
    is ignored and a decoding slot cannot be snapshotted."""
    _, _, config, tparams = models['target']
    _, _, d_config, d_tparams = models['small']
    engine = port_inference.InferenceEngine(
        tparams, config, draft=(d_tparams, d_config), spec_k=K,
        batch_size=2, max_seq_len=SEQ, prefill_chunk=16, kv_page_size=8,
        kv_pages=12, kv_quant='int8', device='cpu')
    main, draft = engine.state.cache, engine.state.draft_cache
    assert main['k']['q'].shape[1] == draft['k'].shape[1] == 13
    assert draft['k'].dtype == d_config.dtype
    assert draft['k'].shape[-2:] == (d_config.num_kv_heads,
                                     d_config.head_dim)
    rid = engine.submit(list(range(3, 20)), port_eng.SamplingParams(
        max_new_tokens=20), handoff=True)
    engine.step()
    assert not engine._handoff_requests and not engine.handoff_pending()
    assert torch.equal(main['table'], draft['table'])
    assert int(main['table'][0, 0]) != 0
    assert torch.equal(main['length'], draft['length'])
    with pytest.raises(port_eng.SnapshotError, match='not migratable'):
        engine.snapshot_request(rid)
    queued = engine.submit([1, 2, 3], port_eng.SamplingParams())
    engine.snapshot_request(queued)        # host-only: still allowed
    engine.abort(rid)
    assert torch.equal(main['table'], draft['table'])
    assert int(main['table'][0].abs().sum()) == 0
    assert int(draft['length'][0]) == 0 == int(main['length'][0])
    engine.abort(queued)
    assert engine.pages_free() == engine.pages_total()
    plain = port_inference.InferenceEngine(
        tparams, config, batch_size=2, max_seq_len=SEQ, prefill_chunk=16,
        kv_page_size=8, kv_pages=12, kv_quant='int8', device='cpu')
    moving = plain.submit(list(range(3, 20)), port_eng.SamplingParams(
        max_new_tokens=20))
    plain.step()
    with pytest.raises(port_eng.SnapshotError, match='not migratable'):
        engine.restore_request(plain.snapshot_request(moving))
