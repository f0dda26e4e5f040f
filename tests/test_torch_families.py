"""Port parity: the gemma, mistral and qwen presets against the JAX model.

- Every preset of `skypilot_tpu/models/{gemma,mistral,qwen}.py` equals
  the port's, field for field (dtype mapped), and `models.resolve`
  returns it; the MoE presets resolve to the port's moe family.
- tiny-gemma, tiny-mistral and tiny-qwen forward logits against the JAX
  forward in f32 on the same weights, with prompts longer than their
  16-token windows: max|a-b|/max|b| < 1e-4.
- The port's engine against the JAX engine on tiny-gemma (local and
  global layers, softcaps, post-norms, tied embeddings): greedy tokens
  equal, dense and paged, dense attention and the flash path's plain
  version.
- head_dim 256 on CUDA: the engine routes prefill chunks to K1/K2, and a
  flash training config there (gemma2-2b/9b) passes the trainer's kernel
  check (K3/K4 have d 256 instances), while one at a head_dim the
  backward is not built for is refused before any step; the CPU trains
  either through the plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.models import gemma as ref_gemma
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.models import mistral as ref_mistral
from skypilot_tpu.models import qwen as ref_qwen
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import models as port_models
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng
from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import mistral
from skypilot_tpu_torch.models import qwen
from skypilot_tpu_torch.train import loop as train_loop
from skypilot_tpu_torch.train import trainer

TOL = 1e-4
FAMILIES = [(ref_gemma, gemma), (ref_mistral, mistral), (ref_qwen, qwen)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    # Tiny models: several torch threads only crowd the suite's workers.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('ref_family,family', FAMILIES,
                         ids=['gemma', 'mistral', 'qwen'])
def test_presets_equal_the_reference_and_resolve(ref_family, family):
    assert set(family.CONFIGS) == set(ref_family.CONFIGS)
    for name, ref_config in ref_family.CONFIGS.items():
        want = dataclasses.asdict(ref_config)
        got = dataclasses.asdict(family.CONFIGS[name])
        assert weights.dtype_from_name(want.pop('dtype')) == got.pop('dtype')
        assert got == want, name
        assert port_models.resolve(name) == (family, family.CONFIGS[name])
    for fn in ('init_params', 'forward', 'loss_fn'):
        assert getattr(family, fn) is getattr(llama, fn)
    assert family.LlamaConfig is llama.LlamaConfig


def test_moe_presets_still_raise():
    """Since the MoE slice the presets no longer raise: each resolves to
    the port's moe family (tests/test_torch_moe.py holds them to the
    reference field for field)."""
    from skypilot_tpu_torch.models import moe
    for name in ('mixtral-8x7b', 'dbrx-moe', 'tiny-moe'):
        family, config = port_models.resolve(name)
        assert family is moe and config is moe.CONFIGS[name]
        assert isinstance(config, moe.MoeConfig)
    assert 'deepseek-r1-distill-qwen-7b' in qwen.CONFIGS
    assert qwen.CONFIGS['deepseek-r1-distill-qwen-7b'].rope_theta == 1e4


def _pair(ref_config, seed=3):
    params = ref_llama.init_params(ref_config, jax.random.key(seed))
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    return params, config, weights.from_jax_params(
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize('name,ref_family', [
    ('tiny-gemma', ref_gemma), ('tiny-mistral', ref_mistral),
    ('tiny-qwen', ref_qwen)])
def test_tiny_forward_matches_reference(name, ref_family):
    ref_config = ref_family.CONFIGS[name]
    assert ref_config.sliding_window in (16, None)
    params, config, tparams = _pair(ref_config)
    tokens = np.random.default_rng(1).integers(
        0, ref_config.vocab_size, (2, 40)).astype(np.int32)
    want = np.asarray(ref_family.forward(params, jnp.asarray(tokens),
                                         ref_config))
    got = port_models.resolve(name)[0].forward(
        tparams, torch.from_numpy(tokens).long(), config).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < TOL


# -- the engine on tiny-gemma ------------------------------------------------

# Prompts past the 16-token window, one shorter than it; max_new past it.
REQUESTS = [(list(range(3, 11)), 12), (list(range(20, 62)), 12),
            (list(range(70, 95)), 6)]
ENGINE_KW = dict(batch_size=3, max_seq_len=64, prefill_chunk=16,
                 prefill_interleave=32, decode_fuse_steps=4)


def _drain(engine):
    out = {}
    for _ in range(500):
        if not engine.has_work:
            break
        engine.step()
        out.update(engine.finished())
    return out


@pytest.fixture(scope='module')
def gemma_runs():
    ref_config = ref_gemma.CONFIGS['tiny-gemma']
    params, config, tparams = _pair(ref_config, seed=5)
    engine = ref_inference.InferenceEngine(
        params, ref_config, prefix_cache=False, kv_page_size=8, **ENGINE_KW)
    for prompt, max_new in REQUESTS:
        engine.submit(prompt, ref_inference.SamplingParams(
            max_new_tokens=max_new))
    return config, tparams, _drain(engine)


@pytest.mark.parametrize('use_flash', [False, True],
                         ids=['dense_attn', 'flash_plain'])
@pytest.mark.parametrize('kv_page_size', [0, 8], ids=['dense', 'paged'])
def test_gemma_engine_greedy_matches_reference(gemma_runs, kv_page_size,
                                               use_flash):
    config, tparams, want = gemma_runs
    engine = inference.InferenceEngine(
        tparams, config, device='cpu', kv_page_size=kv_page_size,
        use_flash=use_flash, **ENGINE_KW)
    for prompt, max_new in REQUESTS:
        engine.submit(prompt, inference.SamplingParams(
            max_new_tokens=max_new))
    got = _drain(engine)
    assert got == want
    assert [len(got[i]) for i in range(3)] == [12, 12, 6]


# -- head_dim 256 on CUDA ----------------------------------------------------

def test_engine_routes_head_dim_256_prefill_to_the_kernel():
    cuda = torch.device('cuda')
    ok = port_eng._flash_prefill_ok
    # gemma2-9b's heaviest chunk and a warm tail.
    assert ok(512, 8192, 256, cuda) and ok(16, 2048, 256, cuda)
    assert not ok(1, 8192, 256, cuda)
    assert gemma.CONFIGS['gemma2-9b'].head_dim == 256
    # Global layers reach the kernel as a window of 2**30 (windowed=1).
    windows = llama.layer_windows(gemma.CONFIGS['gemma2-9b'])
    assert windows[:2] == [4096, 2 ** 30] and len(windows) == 42


def test_trainer_refuses_head_dim_256_flash_on_cuda(monkeypatch):
    """A flash config at a head_dim K3/K4 are not built for (tiny-gemma's
    d 16) is refused before any parameter is drawn or kernel launched:
    the check runs on the resolved device, here made CUDA without a
    card. gemma2-2b and gemma2-9b at d 256 are no longer refused."""
    calls = []
    monkeypatch.setattr(trainer.device_lib, 'resolve_device',
                        lambda device=None: torch.device('cuda'))
    monkeypatch.setattr(gemma, 'init_params',
                        lambda *a, **k: calls.append(a))
    cfg = trainer.TrainerConfig(model='tiny-gemma', attention_impl='flash',
                                batch_size=1, seq_len=64, max_steps=1)
    assert cfg.model_config().head_dim == 16
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        train_loop.fit(cfg)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trainer.make_train_step(cfg)
    assert not calls
    # gemma2-2b's flash preset (d 256) builds its step on CUDA, and the
    # kernel check passes it and gemma2-9b, with dense attention too, and
    # llama at d 128.
    cfg = trainer.TrainerConfig(model='gemma2-2b', batch_size=1,
                                seq_len=8192, max_steps=1)
    assert cfg.model_config().attention_impl == 'flash'
    assert callable(trainer.make_train_step(cfg))
    for name in ('gemma2-2b', 'gemma2-9b'):
        for impl in ('flash', 'dense'):
            trainer.check_kernels(dataclasses.replace(
                gemma.CONFIGS[name], attention_impl=impl),
                torch.device('cuda'))
    trainer.check_kernels(llama.CONFIGS['bench-8b'], torch.device('cuda'))
    assert not calls


def test_head_dim_256_flash_config_trains_on_cpu(monkeypatch):
    """gemma2-2b's attention (head_dim 256, window, softcaps, flash) at a
    tiny width trains on the CPU through the plain versions."""
    tiny_d256 = dataclasses.replace(
        gemma.CONFIGS['tiny-gemma'], head_dim=256, num_heads=2,
        num_kv_heads=1, attention_impl='flash', attention_block_size=16)
    monkeypatch.setitem(gemma.CONFIGS, 'tiny-gemma-d256', tiny_d256)
    cfg = trainer.TrainerConfig(model='tiny-gemma-d256', batch_size=2,
                                seq_len=32, max_steps=3, warmup_steps=1,
                                learning_rate=1e-2)
    res = train_loop.fit(cfg, device='cpu', log_every=1,
                         log_fn=lambda *_: None)
    losses = [h['loss'] for h in res['history']]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
