"""Port parity: the MoE family through the port's engine, server,
checkpoints and trainer, against the JAX package.

tiny-moe in f32 on the CPU, weights from the reference `init_params`
(numpy -> `weights.from_jax_params`). Greedy tokens and page ids are
compared exactly; train losses within 1e-5 and grad norms within 2e-4
(tests/test_torch_train.py's limits). The JAX engines are built once per
module.
"""
import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.models import moe as ref_moe
from skypilot_tpu.parallel import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as ref_trainer
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.checkpoints import hf_export
from skypilot_tpu_torch.inference import server as server_lib
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.train import checkpoints
from skypilot_tpu_torch.train import loop
from skypilot_tpu_torch.train import trainer

TOL_LOSS = 1e-5
TOL_GRAD = 2e-4
ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, kv_quant='none', decode_fuse_steps=2,
                 prefix_cache=True)
PREFIX = [i % 97 + 1 for i in range(40)]
REQUESTS = ((PREFIX + [7, 8], 6), (PREFIX + [9, 10, 11], 6),
            (list(range(3, 30)), 5), (PREFIX[:24] + [50] * 5, 6))


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_moe.CONFIGS['tiny-moe']
    params = ref_moe.init_params(ref_config, jax.random.key(3))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params),
                                      config)
    return ref_config, params, config, tparams


def _greedy(pkg, max_new):
    return pkg.SamplingParams(temperature=0.0, max_new_tokens=max_new)


def _oracle(tparams, config, prompt, steps):
    """Greedy tokens of the full forward at the engine's drop-free
    capacity, re-run over the growing sequence (padded to 64)."""
    exact = dataclasses.replace(
        config, capacity_factor=config.num_experts / config.num_experts_per_tok)
    tokens, out = list(prompt), []
    with torch.no_grad():
        for _ in range(steps):
            arr = torch.tensor([tokens + [0] * (64 - len(tokens))])
            logits, _ = moe.forward(tparams, arr, exact)
            out.append(int(torch.argmax(logits[0, len(tokens) - 1])))
            tokens.append(out[-1])
    return out


@pytest.mark.parametrize('use_flash', [False, True],
                         ids=['dense_attn', 'flash'])
def test_engine_matches_reference_step_by_step(tiny, use_flash):
    """Chunked prefill into paged KV with the prefix cache on, fused
    decode: after every step the two engines hold the same page lists,
    shared sets and free list, and finish the same greedy tokens; the
    serving capacity rule gives the reference engine's config."""
    ref_config, params, config, tparams = tiny
    kw = dict(ENGINE_KW, use_flash=use_flash)
    ref = ref_inference.InferenceEngine(params, ref_config, **kw)
    port = inference.InferenceEngine(tparams, config, device='cpu', **kw)
    assert port.config.capacity_factor == 2.0        # raised from 1.25
    want = dataclasses.asdict(ref.config)
    got = dataclasses.asdict(port.config)
    assert weights.dtype_from_name(want.pop('dtype')) == got.pop('dtype')
    assert got == want
    done_ref, done_port = {}, {}
    for prompt, max_new in REQUESTS:
        assert port.submit(prompt, _greedy(inference, max_new)) == \
            ref.submit(prompt, _greedy(ref_inference, max_new))
    while ref.has_work or port.has_work:
        ref.step()
        port.step()
        done_ref.update(ref.finished())
        done_port.update(port.finished())
        assert port._slot_pages == ref._slot_pages
        assert port._slot_shared == ref._slot_shared
        assert port._page_alloc == ref._page_alloc
        assert done_port == done_ref
    assert sorted(done_port) == list(range(len(REQUESTS)))
    assert port.stats['prefix_hits'] >= 1


def test_cached_decode_matches_forward(tiny):
    """The reference's test_moe_cached_decode_matches_forward: the
    engine (dense and paged) reproduces the full forward token for
    token at the drop-free capacity."""
    _, _, config, tparams = tiny
    prompt, steps = [5, 9, 2, 14, 7, 11, 3, 8], 6
    want = _oracle(tparams, config, prompt, steps)
    for page in (0, 8):
        engine = inference.InferenceEngine(tparams, config, batch_size=2,
                                           max_seq_len=64, kv_page_size=page,
                                           device='cpu')
        rid = engine.submit(prompt, _greedy(inference, steps))
        assert engine.run_to_completion()[rid] == want, page


def test_request_migrates_token_for_token(tiny):
    """A request snapshotted mid-decode and restored in another engine
    (port to port, and port to the JAX engine) ends as an uninterrupted
    run does."""
    ref_config, params, config, tparams = tiny
    kw = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
              kv_page_size=8, kv_quant='none', decode_fuse_steps=2,
              prefix_cache=False)
    prompt, steps = list(range(20, 45)), 10

    def port_engine():
        return inference.InferenceEngine(tparams, config, device='cpu', **kw)

    engine = port_engine()
    rid = engine.submit(prompt, _greedy(inference, steps))
    want = engine.run_to_completion()[rid]
    for dst in (port_engine(),
                ref_inference.InferenceEngine(params, ref_config, **kw)):
        src = port_engine()
        rid = src.submit(prompt, _greedy(inference, steps))
        while len(src.active_progress().get(rid, ())) < 4:
            src.step()
        blob = src.snapshot_request(rid)
        src.abort(rid)
        rid2 = dst.restore_request(blob)
        assert dst.run_to_completion()[rid2] == want


def test_server_serves_moe_over_http(tiny):
    """The reference's test_http_server_serves_moe on the port's stdlib
    server: /generate matches the full-forward oracle."""
    _, _, config, tparams = tiny
    prompt = [4, 19, 33, 2]
    want = _oracle(tparams, config, prompt, 5)
    engine = inference.InferenceEngine(tparams, config, batch_size=2,
                                       max_seq_len=64, device='cpu')
    holder = {'loop': server_lib.EngineLoop(engine)}
    srv = server_lib.create_server(holder, host='127.0.0.1', port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f'http://127.0.0.1:{srv.server_address[1]}/generate',
            data=json.dumps({'prompt_tokens': prompt,
                             'max_new_tokens': 5}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())['tokens'] == want
    finally:
        srv.shutdown()
        srv.server_close()
        holder['loop'].stop()


def test_train_saved_moe_serves_and_a_wrong_geometry_raises(tiny, tmp_path):
    """The reference's test_moe_checkpoint_serves: params saved by
    training restore with the preset's geometry (router [L,E,X],
    w_gate/w_up [L,X,E,M], w_down [L,X,M,E]) and decode through the
    engine and build_engine; another geometry raises ValueError; HF
    export of MoE raises NotImplementedError."""
    _, _, config, tparams = tiny
    cfg = trainer.TrainerConfig(model='tiny-moe')
    state = trainer.make_train_state(cfg, 'cpu', params=tparams)
    checkpoints.save_train_state(str(tmp_path), state, step=1)
    restored = inference.restore_params(str(tmp_path), torch.device('cpu'),
                                        config)[0]
    assert restored['layers']['router'].dtype == torch.float32
    want = None
    for params in (tparams, restored):
        engine = inference.InferenceEngine(params, config, batch_size=1,
                                           max_seq_len=32, device='cpu')
        rid = engine.submit([3, 1, 4], _greedy(inference, 3))
        out = engine.run_to_completion()[rid]
        assert len(out) == 3 and (want is None or out == want)
        want = out
    engine = inference.build_engine('tiny-moe', device='cpu',
                                    checkpoint=str(tmp_path), batch_size=1,
                                    max_seq_len=32)
    rid = engine.submit([3, 1, 4], _greedy(inference, 3))
    assert engine.run_to_completion()[rid] == want
    for wrong in (dataclasses.replace(config, num_experts=8),
                  dataclasses.replace(config, intermediate_size=64)):
        with pytest.raises(ValueError, match='do not fit'):
            checkpoints.restore_params(str(tmp_path), wrong, 'cpu')
    with pytest.raises(ValueError, match='do not fit'):
        inference.build_engine('tiny', device='cpu',
                               checkpoint=str(tmp_path))
    with pytest.raises(NotImplementedError, match='MoE'):
        hf_export.export_params(tparams, config, str(tmp_path / 'hf'))


def test_router_stays_f32_through_the_trainer(tiny):
    """In a bf16 model: make_train_state (random and given params) and
    the fine-tune copy `loop._adopt` keep the router f32."""
    _, _, config, tparams = tiny
    bf16 = dataclasses.replace(moe.CONFIGS['tiny-moe'], dtype=torch.bfloat16)
    moe.CONFIGS['tiny-moe-bf16'] = bf16
    try:
        cfg = trainer.TrainerConfig(model='tiny-moe-bf16')
        for given in (None, tparams):
            state = trainer.make_train_state(cfg, 'cpu', params=given)
            layers = state['params']['layers']
            assert layers['router'].dtype == torch.float32
            assert layers['w_up'].dtype == torch.bfloat16
            assert state['opt_state']['nu']['layers']['router'].dtype == \
                torch.float32
        loaded = trainer.tree_map(lambda t: t.detach().clone(), tparams)
        loaded['layers']['router'] += 1e-3    # f32 bits below bf16's step
        loop._adopt(state['params'], loaded)
        assert torch.equal(state['params']['layers']['router'],
                           loaded['layers']['router'])
    finally:
        del moe.CONFIGS['tiny-moe-bf16']


def test_trainer_matches_the_jax_trainer(tiny):
    """The reference's test_moe_trainer_step on one device: three steps
    of the generic trainer on tiny-moe, loss and grad norm step for
    step."""
    kw = dict(model='tiny-moe', batch_size=2, seq_len=32, warmup_steps=1,
              learning_rate=1e-2, max_steps=10)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    ref_cfg = ref_trainer.TrainerConfig(**kw)
    ref_state = ref_trainer.make_train_state(ref_cfg, mesh)
    ref_step = ref_trainer.make_train_step(ref_cfg, mesh)
    cfg = trainer.TrainerConfig(**kw)
    state = trainer.make_train_state(
        cfg, 'cpu', params=weights.from_jax_params(
            jax.tree.map(np.asarray, ref_state['params'])))
    step = trainer.make_train_step(cfg, 'cpu')
    rng = np.random.default_rng(6)
    losses = []
    for i in range(3):
        tokens = rng.integers(0, 256, (2, 32)).astype(np.int32)
        ref_state, want = ref_step(ref_state, {'tokens': jnp.asarray(tokens)})
        state, got = step(state, {'tokens': torch.from_numpy(tokens).long()})
        np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                                   rtol=TOL_LOSS, atol=TOL_LOSS)
        np.testing.assert_allclose(float(got['grad_norm']),
                                   float(want['grad_norm']), rtol=TOL_GRAD,
                                   atol=TOL_GRAD)
        losses.append(float(got['loss']))
    assert all(np.isfinite(losses))
    # The MFU of a MoE counts the active params (top-k of the experts).
    mcfg = cfg.model_config()
    assert trainer.mfu(1.0, mcfg, 32, 1.0) == mcfg.flops_per_token(32)
    assert mcfg.active_params() < mcfg.num_params()
