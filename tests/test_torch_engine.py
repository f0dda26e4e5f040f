"""Port parity: skypilot_tpu_torch.inference.engine against the JAX engine.

Both engines run the `tiny` config in f32 on the CPU with the same
weights (reference `init_params` -> numpy -> `weights.from_jax_params`)
and the same prompts. Tolerances: prefill logits and the visible cache
2e-4 (as the reference's own flash-vs-dense test); logprobs 1e-4;
greedy tokens exactly. int8 cache codes may differ by one step where an
f32 value sits on a rounding boundary (the projections sum in another
order), so codes are held to |diff| <= 1 on at most 1% of entries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import envs as ref_envs
from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import engine as ref_eng
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu_torch import envs as port_envs
from skypilot_tpu_torch import inference as port_inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params))
    return ref_config, params, config, tparams


# -- quantize_kv ------------------------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_kv_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3.0
    # Half-way codes: amax 127 gives scale 1, so x/scale hits .5 exactly
    # and both sides must round half to even.
    x[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] + [0.0] * 8
    x[1, 1, 1] = 0.0  # all-zero row: the 1e-8 scale floor
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = ref_eng.quantize_kv(xj)
    got = port_eng.quantize_kv(weights.to_tensor(np.asarray(xj)))
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_array_equal(got['s'].numpy(), np.asarray(want['s']))


# -- prefill ----------------------------------------------------------------

PROMPTS = [list(range(3, 25)), list(range(40, 45))]
LAYOUTS = {'dense': {}, 'paged': dict(page_size=8),
           'int8_paged': dict(page_size=8, kv_quant='int8')}


def _with_table(cache, table):
    if 'table' in cache:
        cache['table'] = table
    return cache


def _logical(leaf, table, b, n):
    """Positions 0..n-1 of slot b as [L, n, ...] (dense or paged)."""
    leaf = np.asarray(leaf)
    if table is None:
        return leaf[:, b, :n]
    page = leaf.shape[2]
    pos = np.arange(n)
    return leaf[:, np.asarray(table)[b, pos // page], pos % page]


def _assert_cache_close(got, want, table, lengths):
    for name in ('k', 'v'):
        for b, n in enumerate(lengths):
            if isinstance(want[name], dict):
                g = _logical(got[name]['s'].numpy(), table, b, n)
                w = _logical(want[name]['s'], table, b, n)
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
                gq = _logical(got[name]['q'].numpy(), table, b, n)
                wq = _logical(want[name]['q'], table, b, n)
                diff = np.abs(gq.astype(np.int32) - wq.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
            else:
                np.testing.assert_allclose(
                    _logical(got[name].numpy(), table, b, n),
                    _logical(want[name], table, b, n),
                    rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('use_flash', [False, True],
                         ids=['dense_attn', 'flash'])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_prefill_chunked_matches_reference(tiny, layout, use_flash):
    ref_config, params, config, tparams = tiny
    kw = LAYOUTS[layout]
    maxlen = 32
    padded = np.array([p + [0] * (maxlen - len(p)) for p in PROMPTS],
                      np.int32)
    lengths = [len(p) for p in PROMPTS]
    table = None
    if 'page_size' in kw:
        w = 64 // kw['page_size']
        table = np.arange(1, 1 + 2 * w, dtype=np.int32).reshape(2, w)
    ref_cache = _with_table(ref_eng.init_cache(ref_config, 2, 64, **kw),
                            None if table is None else jnp.asarray(table))
    want_logits, want_cache = ref_eng.prefill_chunked(
        params, jnp.asarray(padded), jnp.asarray(lengths, jnp.int32),
        ref_cache, jnp.arange(2, dtype=jnp.int32), ref_config, chunk=8,
        use_flash=use_flash)
    cache = port_eng.init_cache(config, 2, 64, device='cpu', **kw)
    cache = _with_table(cache,
                        None if table is None else torch.from_numpy(table))
    logits, got_cache = port_eng.prefill_chunked(
        tparams, torch.from_numpy(padded).long(),
        torch.tensor(lengths, dtype=torch.int32), cache,
        torch.arange(2), config, chunk=8, use_flash=use_flash)
    assert got_cache is cache  # updated in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=2e-4, atol=2e-4)
    _assert_cache_close(got_cache, want_cache, table, lengths)
    np.testing.assert_array_equal(got_cache['length'].numpy(),
                                  np.asarray(want_cache['length']))


@pytest.mark.parametrize('use_flash', [False, True],
                         ids=['dense_attn', 'flash'])
@pytest.mark.parametrize('knobs', [
    dict(sliding_window=6, sliding_window_pattern=2),
    dict(attn_logit_softcap=50.0, query_pre_attn_scalar=16.0),
], ids=['window', 'softcap'])
def test_prefill_family_knobs_match_reference(tiny, knobs, use_flash):
    """Per-layer windows and logit softcap reach the cached attention
    (and the flash path) as in the reference."""
    ref_config, params, _, tparams = tiny
    ref_config = dataclasses.replace(ref_config, **knobs)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    padded = np.array([p + [0] * (32 - len(p)) for p in PROMPTS], np.int32)
    lengths = np.array([len(p) for p in PROMPTS], np.int32)
    want, _ = ref_eng.prefill_chunked(
        params, jnp.asarray(padded), jnp.asarray(lengths),
        ref_eng.init_cache(ref_config, 2, 64),
        jnp.arange(2, dtype=jnp.int32), ref_config, chunk=8,
        use_flash=use_flash)
    got, _ = port_eng.prefill_chunked(
        tparams, torch.from_numpy(padded).long(), torch.from_numpy(lengths),
        port_eng.init_cache(config, 2, 64, device='cpu'), torch.arange(2),
        config, chunk=8, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_decode_step_matches_reference(tiny):
    """Three host-stepped decode steps after prefill, slot 1 inactive:
    greedy tokens, raw-model logprobs and lengths as the reference."""
    ref_config, params, config, tparams = tiny
    padded = np.array([p + [0] * (32 - len(p)) for p in PROMPTS], np.int32)
    lengths = np.array([len(p) for p in PROMPTS], np.int32)
    active = np.array([True, False])
    ref_cache = ref_eng.init_cache(ref_config, 2, 64)
    _, ref_cache = ref_eng.prefill_chunked(
        params, jnp.asarray(padded), jnp.asarray(lengths), ref_cache,
        jnp.arange(2, dtype=jnp.int32), ref_config, chunk=32)
    cache = port_eng.init_cache(config, 2, 64, device='cpu')
    port_eng.prefill_chunked(tparams, torch.from_numpy(padded).long(),
                             torch.from_numpy(lengths), cache,
                             torch.arange(2), config, chunk=32)
    last = np.array([7, 9], np.int32)
    ref_last, port_last = jnp.asarray(last), torch.from_numpy(last)
    zeros = np.zeros(2, np.float32)
    for _ in range(3):
        ref_last, ref_lp, ref_cache = ref_eng.decode_step(
            params, ref_cache, ref_last, jnp.asarray(active),
            jnp.asarray(zeros), jnp.zeros(2, jnp.int32), jnp.ones(2),
            jax.random.key(0), ref_config)
        port_last, lp, cache = port_eng.decode_step(
            tparams, cache, port_last, torch.from_numpy(active),
            torch.from_numpy(zeros), torch.zeros(2, dtype=torch.int32),
            torch.ones(2), None, config)
        np.testing.assert_array_equal(port_last.numpy(),
                                      np.asarray(ref_last))
        np.testing.assert_allclose(lp.numpy()[active],
                                   np.asarray(ref_lp)[active], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(cache['length'].numpy(),
                                  np.asarray(ref_cache['length']))


def test_interleaved_chunks_match_one_shot_prefill(tiny):
    """prefill_chunk_at, chunk by chunk, writes the cache and yields the
    hidden state that one-shot prefill_chunked does."""
    _, _, config, tparams = tiny
    prompt = list(range(5, 45))
    n = len(prompt)
    one = port_eng.init_cache(config, 1, 64, page_size=8, device='cpu')
    one['table'][0] = torch.arange(1, 9)
    padded = torch.tensor([prompt + [0] * (48 - n)])
    want, _ = port_eng.prefill_chunked(
        tparams, padded, torch.tensor([n], dtype=torch.int32), one,
        torch.arange(1), config, chunk=16, use_flash=True)
    inc = port_eng.init_cache(config, 1, 64, page_size=8, device='cpu')
    inc['table'][0] = torch.arange(1, 9)
    for start in range(0, n, 16):
        toks = prompt[start:start + 16]
        hidden, _ = port_eng.prefill_chunk_at(
            tparams, torch.tensor([toks + [0] * (16 - len(toks))]), start,
            torch.tensor([min(n, start + 16)], dtype=torch.int32), inc,
            torch.arange(1), config, 16, use_flash=True)
    got = port_eng._project_logits(hidden[:, n - 1 - start], tparams,
                                   config)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(inc['k'][:, 1:6].numpy(),
                               one['k'][:, 1:6].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert inc['length'].tolist() == one['length'].tolist() == [n]


# -- engines end to end ------------------------------------------------------

# (prompt, max_new_tokens): mixed lengths, a 5-token budget stop, and a
# 40-token prompt that prefills interleaved (threshold 24, chunk 16);
# batch 3 makes the fourth request wait for a slot.
REQUESTS = [(list(range(3, 8)), 17), (list(range(30, 52)), 17),
            (list(range(60, 69)), 5), (list(range(100, 140)), 17)]
ENGINE_KW = dict(batch_size=3, max_seq_len=64, prefill_chunk=16,
                 prefill_interleave=24, decode_fuse_steps=8)


def _drain(engine):
    tokens, logprobs = {}, {}
    for _ in range(1000):
        if not engine.has_work:
            break
        engine.step()
        done = engine.finished()
        if done:
            tokens.update(done)
            logprobs.update(engine.finished_logprobs())
    return tokens, logprobs


def _run_port(tparams, config, eos, **kw):
    engine = port_inference.InferenceEngine(tparams, config, device='cpu',
                                            **ENGINE_KW, **kw)
    for i, (prompt, max_new) in enumerate(REQUESTS):
        engine.submit(prompt, port_eng.SamplingParams(
            max_new_tokens=max_new, eos_token_id=eos if i == 0 else None))
    return _drain(engine)


def _run_ref(params, ref_config, eos, **kw):
    engine = ref_inference.InferenceEngine(params, ref_config,
                                           prefix_cache=False, **ENGINE_KW,
                                           **kw)
    for i, (prompt, max_new) in enumerate(REQUESTS):
        engine.submit(prompt, ref_inference.SamplingParams(
            max_new_tokens=max_new, eos_token_id=eos if i == 0 else None))
    return _drain(engine)


@pytest.fixture(scope='module')
def eos_tokens(tiny):
    """Per cache dtype, a token request 0 emits mid-stream greedily, so
    eos stops it there."""
    _, _, config, tparams = tiny
    out = {}
    for quant in ('none', 'int8'):
        tokens, _ = _run_port(tparams, config, None, kv_page_size=8,
                              kv_quant=quant)
        out[quant] = tokens[0][6]
    return out


@pytest.fixture(scope='module')
def ref_runs(tiny, eos_tokens):
    ref_config, params, _, _ = tiny
    return {
        'none': _run_ref(params, ref_config, eos_tokens['none'],
                         kv_page_size=0, kv_quant='none'),
        'int8': _run_ref(params, ref_config, eos_tokens['int8'],
                         kv_page_size=8, kv_quant='int8'),
    }


@pytest.mark.parametrize('use_flash', [False, True],
                         ids=['dense_attn', 'flash'])
@pytest.mark.parametrize('layout', [
    dict(kv_page_size=0, kv_quant='none'),
    dict(kv_page_size=8, kv_quant='none'),
    dict(kv_page_size=8, kv_quant='int8'),
], ids=['dense', 'paged', 'int8_paged'])
def test_engine_greedy_matches_reference(tiny, eos_tokens, ref_runs, layout,
                                         use_flash):
    _, _, config, tparams = tiny
    want_tokens, want_lps = ref_runs[layout['kv_quant']]
    eos_token = eos_tokens[layout['kv_quant']]
    tokens, lps = _run_port(tparams, config, eos_token, use_flash=use_flash,
                            **layout)
    assert tokens == want_tokens
    # Stops: eos ends request 0 early, request 2 at its budget of 5.
    assert tokens[0][-1] == eos_token and len(tokens[0]) < 17
    assert len(tokens[2]) == 5
    assert [len(tokens[i]) for i in (1, 3)] == [17, 17]
    for rid, want in want_lps.items():
        np.testing.assert_allclose(lps[rid], want, rtol=1e-4, atol=1e-4)


def test_interleaved_prefill_matches_one_shot_engine(tiny):
    _, _, config, tparams = tiny
    prompt = list(range(7, 57))

    def run(interleave):
        engine = port_inference.InferenceEngine(
            tparams, config, batch_size=2, max_seq_len=96, prefill_chunk=16,
            prefill_interleave=interleave, kv_page_size=8, device='cpu')
        rid = engine.submit(prompt, port_eng.SamplingParams(
            max_new_tokens=10))
        return engine.run_to_completion()[rid]

    assert run(0) == run(20)


def test_sampling_filters_reduce_to_greedy(tiny):
    """RNG streams differ from jax.random by design, so sampling is held
    to its distribution: top_k=1, or a tiny top_p, is greedy."""
    logits = torch.tensor(np.random.default_rng(3).standard_normal(
        (4, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    for top_k, top_p in ((1, 1.0), (0, 1e-6)):
        toks, lps = port_eng._sample(
            logits, torch.full((4,), 0.9), torch.full((4,), top_k,
                                                      dtype=torch.int32),
            torch.full((4,), top_p), gen)
        assert torch.equal(toks, greedy)
        want = torch.log_softmax(logits, -1)[torch.arange(4), greedy.long()]
        np.testing.assert_allclose(lps.numpy(), want.numpy(), rtol=1e-6)
    # Greedy rows ignore the generator and match the reference exactly.
    want_t, want_lp = ref_eng._sample(
        jnp.asarray(logits.numpy()), jnp.zeros(4), jnp.zeros(4, jnp.int32),
        jnp.ones(4), jax.random.key(0))
    toks, lps = port_eng._sample(logits, torch.zeros(4),
                                 torch.zeros(4, dtype=torch.int32),
                                 torch.ones(4), gen)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(lps.numpy(), np.asarray(want_lp), rtol=1e-6)


# -- H100 policy and knobs ---------------------------------------------------


def test_h100_policy_defaults(tiny, monkeypatch):
    _, _, config, tparams = tiny
    assert port_eng.default_use_flash(torch.device('cuda')) is True
    assert port_eng.default_use_flash(torch.device('cpu')) is False
    monkeypatch.delenv('SKYTPU_KV_QUANT', raising=False)
    assert port_eng.resolve_kv_quant('auto') == 'none'
    assert port_eng.resolve_kv_quant(None) == 'none'
    assert port_eng.resolve_kv_quant('int8') == 'int8'
    monkeypatch.setenv('SKYTPU_KV_QUANT', 'int8')
    assert port_eng.resolve_kv_quant('auto') == 'int8'
    monkeypatch.delenv('SKYTPU_KV_QUANT')
    cuda = torch.device('cuda')
    ok = port_eng._flash_prefill_ok
    # The CUDA gate is what the kernel serves: t >= 2 and head dim in
    # its built set; ragged chunks are fine (the kernel masks them).
    assert not ok(1, 2048, 128, cuda)
    assert ok(2, 2048, 128, cuda) and ok(600, 2048, 128, cuda)
    assert ok(100, 1000, 64, cuda)
    assert not ok(512, 2048, 96, cuda) and not ok(512, 2048, 16, cuda)
    # The CPU keeps the reference's rule.
    for t, s, d in ((1, 64, 16), (8, 64, 16), (600, 2048, 16),
                    (512, 2048, 128), (16, 40, 16)):
        assert ok(t, s, d, torch.device('cpu')) == ref_eng._flash_prefill_ok(
            t, s, d)
    monkeypatch.delenv('SKYTPU_PREFIX_CACHE', raising=False)
    engine = port_inference.InferenceEngine(tparams, config, device='cpu')
    assert engine._use_flash is False and engine.kv_quant == 'none'
    assert engine.kv_page_size == 64 and engine.decode_fuse_steps == 8
    # The prefix cache is live exactly where the reference's is: paged,
    # chunked engines, unless turned off by argument or knob.
    assert engine._prefix is not None
    for kw, live in ((dict(prefix_cache=True), True),
                     (dict(prefix_cache=False), False),
                     (dict(kv_page_size=0), False),
                     (dict(prefill_chunk=0), False)):
        engine = port_inference.InferenceEngine(tparams, config,
                                                device='cpu', **kw)
        assert (engine._prefix is not None) is live, kw
    monkeypatch.setenv('SKYTPU_PREFIX_CACHE', '0')
    assert port_inference.InferenceEngine(tparams, config,
                                          device='cpu')._prefix is None
    monkeypatch.delenv('SKYTPU_PREFIX_CACHE')
    # A mesh keeps the flash kernels (the reference refuses use_flash
    # under one: pallas_call has no partitioning rules) and the paged
    # pool, unless SKYTPU_KV_PAGES_SHARDED says dense; an explicit page
    # size wins. A context axis keeps the dense layout, and an explicit
    # page size there raises, as in the reference.
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(), 'cpu')
    engine = port_inference.InferenceEngine(tparams, config, mesh=mesh,
                                            use_flash=True)
    assert engine._use_flash is True and engine.kv_page_size == 64
    assert engine.device == torch.device('cpu') and engine.mesh is mesh
    monkeypatch.setenv('SKYTPU_KV_PAGES_SHARDED', '0')
    assert port_inference.InferenceEngine(
        tparams, config, mesh=mesh).kv_page_size == 0
    assert port_inference.InferenceEngine(
        tparams, config, mesh=mesh, kv_page_size=8).kv_page_size == 8
    monkeypatch.delenv('SKYTPU_KV_PAGES_SHARDED')
    context = dataclasses.replace(
        mesh, spec=mesh_lib.MeshSpec(fsdp=1, context=2))
    assert port_inference.InferenceEngine(
        tparams, config, mesh=context).kv_page_size == 0
    with pytest.raises(ValueError, match='context-sharded cache'):
        port_inference.InferenceEngine(tparams, config, mesh=context,
                                       kv_page_size=8)
    # Speculative decode is ported: a draft builds (and turns the prefix
    # cache off, as the reference does).
    engine = port_inference.InferenceEngine(tparams, config, device='cpu',
                                            draft=(tparams, config))
    assert engine.state.draft_cache is not None and engine._prefix is None


def test_env_defaults_match_reference_registry():
    ref_vars = ref_envs.declared()
    port_vars = port_envs.declared()
    assert set(port_vars) == {
        'SKYTPU_DECODE_FUSE_STEPS', 'SKYTPU_KV_PAGE_SIZE', 'SKYTPU_KV_PAGES',
        'SKYTPU_KV_QUANT', 'SKYTPU_PREFILL_INTERLEAVE',
        'SKYTPU_PREFIX_CACHE', 'SKYTPU_PREFIX_CACHE_MAX_PAGES',
        'SKYTPU_MIGRATION_ENABLE', 'SKYTPU_DRAIN_DEADLINE_SECONDS',
        'SKYTPU_MIGRATION_MAX_BYTES', 'SKYTPU_HANDOFF_LEASE_SECONDS',
        'SKYTPU_SPEC_K', 'SKYTPU_SPEC_FUSE_ROUNDS',
        'SKYTPU_WATCHDOG_INTERVAL', 'SKYTPU_HF_IMPORT_STRICT',
        'SKYTPU_HF_IMPORT_CONCURRENCY',
        # the observability plane and the fault registry
        'SKYTPU_FAULTS', 'SKYTPU_TRACE_SAMPLE', 'SKYTPU_TRACE_MAX_SPANS',
        'SKYTPU_TRACE_RECORDER_CAPACITY', 'SKYTPU_TRACE_SLOW_SECONDS',
        'SKYTPU_TRACE_DUMP_DIR', 'SKYTPU_TS_SAMPLE_SECONDS',
        'SKYTPU_TS_CAPACITY', 'SKYTPU_TS_MAX_SERIES',
        'SKYTPU_WATCHDOG_TICK_SECONDS', 'SKYTPU_WATCHDOG_RULES',
        'SKYTPU_WATCHDOG_WINDOW_SECONDS', 'SKYTPU_WATCHDOG_BREACH_TICKS',
        'SKYTPU_WATCHDOG_CLEAR_TICKS', 'SKYTPU_WATCHDOG_ANOMALY_Z',
        # load shedding and the train checkpoints' save retries
        'SKYTPU_MAX_QUEUE_DEPTH', 'SKYTPU_CKPT_RETRY_GAP',
        # the parallel layer: the sharded pool and the gang coordinates
        'SKYTPU_KV_PAGES_SHARDED', 'SKYTPU_COORDINATOR_ADDR',
        'SKYTPU_NUM_PROCESSES', 'SKYTPU_PROCESS_ID',
        # the load balancer, its policies and its migration budgets
        'SKYTPU_LB_POLICY', 'SKYTPU_LB_STREAM_READ_TIMEOUT',
        'SKYTPU_LB_AFFINITY_BOUND', 'SKYTPU_LB_AFFINITY_PAGE_TOKENS',
        'SKYTPU_LB_AFFINITY_MAX_ENTRIES', 'SKYTPU_LB_AFFINITY_LOAD_WINDOW',
        'SKYTPU_LB_POOL_PROMPT_THRESHOLD', 'SKYTPU_LB_POOL_MAX_NEW_THRESHOLD',
        'SKYTPU_HANDOFF_DEADLINE_SECONDS', 'SKYTPU_HANDOFF_MAX_BYTES',
        'SKYTPU_MIGRATION_DEADLINE_SECONDS',
        # the serve control plane and the fleet simulator
        'SKYTPU_CONFIG', 'SKYTPU_STATE_DIR', 'SKYTPU_SERVE_LOOP_INTERVAL',
        'SKYTPU_SERVE_LAUNCH_RETRY_GAP', 'SKYTPU_PROBE_BREAKER_RECOVERY',
        'SKYTPU_FLEETSIM_SEED', 'SKYTPU_FLEETSIM_TICK_SECONDS',
        'SKYTPU_FLEETSIM_SCALE', 'SKYTPU_FLEETSIM_OUT_DIR',
        'SKYTPU_FLEETSIM_MAX_WALL_SECONDS',
        # port-only: the collectives' backend
        'SKYTPU_TORCH_DIST_BACKEND'}
    port_only = {'SKYTPU_TORCH_DIST_BACKEND'}
    assert not port_only & set(ref_vars)
    assert port_vars['SKYTPU_TORCH_DIST_BACKEND'].default is None
    for name, var in port_vars.items():
        if name in port_only:
            continue
        assert (var.type, var.default) == (ref_vars[name].type,
                                           ref_vars[name].default), name


def test_env_knobs_are_read_at_call_time(monkeypatch):
    monkeypatch.setenv('SKYTPU_DECODE_FUSE_STEPS', '3')
    assert port_envs.SKYTPU_DECODE_FUSE_STEPS.get() == 3
    monkeypatch.setenv('SKYTPU_DECODE_FUSE_STEPS', 'x')
    assert port_envs.SKYTPU_DECODE_FUSE_STEPS.get() == 8
    # A per-call default wins over the declared one, as the reference's
    # (the server's watchdog reads SKYTPU_WATCHDOG_INTERVAL at 5 s).
    monkeypatch.delenv('SKYTPU_WATCHDOG_INTERVAL', raising=False)
    for var in (port_envs.SKYTPU_WATCHDOG_INTERVAL,
                ref_envs.SKYTPU_WATCHDOG_INTERVAL):
        assert var.get() == 30.0 and var.get(default=5.0) == 5.0
    monkeypatch.setenv('SKYTPU_WATCHDOG_INTERVAL', '0.3')
    assert port_envs.SKYTPU_WATCHDOG_INTERVAL.get(default=5.0) == 0.3
    # The gang identity parses strictly, as the reference's: a malformed
    # or empty value raises instead of falling back to process 0.
    for value in ('x', ''):
        monkeypatch.setenv('SKYTPU_PROCESS_ID', value)
        for var in (port_envs.SKYTPU_PROCESS_ID,
                    ref_envs.SKYTPU_PROCESS_ID):
            assert var.get() == 0
            with pytest.raises(ValueError, match='SKYTPU_PROCESS_ID'):
                var.get(strict=True)
    monkeypatch.setenv('SKYTPU_PROCESS_ID', '3')
    assert port_envs.SKYTPU_PROCESS_ID.get(strict=True) == 3


def _fifo_admission(tiny, prefix_cache):
    """Two requests through an oversubscribed 6-page pool: the head
    request queues until pages free. Returns the engine afterwards."""
    _, _, config, tparams = tiny
    engine = port_inference.InferenceEngine(
        tparams, config, batch_size=2, max_seq_len=64, prefill_chunk=16,
        kv_page_size=8, kv_pages=6, prefix_cache=prefix_cache,
        device='cpu')
    sp = port_eng.SamplingParams(max_new_tokens=8)
    a = engine.submit(list(range(1, 30)), sp)   # 37 positions: 5 pages
    b = engine.submit(list(range(1, 10)), sp)   # 17 positions: 3 pages
    engine.step()
    assert engine.state.slots[1] is None and engine.queue_depth() == 1
    out = engine.run_to_completion()
    assert sorted(out) == [a, b]
    with pytest.raises(ValueError, match='pool holds only'):
        engine.submit(list(range(1, 60)), sp)
    return engine


def test_page_pool_admission_is_fifo(tiny):
    """An oversubscribed pool queues the head request until pages free,
    and every page returns to the pool afterwards."""
    engine = _fifo_admission(tiny, prefix_cache=False)
    assert engine.pages_free() == 6


def test_page_pool_admission_is_fifo_with_prefix_cache(tiny):
    """The same with the prefix cache on: every page is free again or
    held, unpinned, by the cache (the published full pages)."""
    engine = _fifo_admission(tiny, prefix_cache=True)
    assert engine.pages_cached() > 0
    assert engine.pages_free() + engine.pages_cached() == 6
    assert not any(engine._prefix.refcount(p) for p in range(1, 7))
