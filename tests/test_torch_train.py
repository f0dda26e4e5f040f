"""Port parity: model accounting, loss, optimizer, train step and fit.

The reference side is skypilot_tpu.models.llama / skypilot_tpu.train on
a one-device CPU mesh; the port side is skypilot_tpu_torch on the CPU
(plain versions of the kernels). Weights come from the reference
`init_params` (numpy -> `weights.from_jax_params`), tokens and masks
from numpy. The `tiny` config runs in f32. Tolerances: loss 1e-5 and
grads 2e-4 (tests/unit/test_attention.py's grad tolerance; f32 on both
sides, only the summation order differs); train-step params and moments
2e-4 (Adam divides by sqrt(v), so a gradient's relative error passes
into the update almost unchanged); the schedule and the clip 1e-6.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.parallel import MeshSpec, make_mesh
from skypilot_tpu.train import trainer as ref_trainer
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import loop
from skypilot_tpu_torch.train import trainer

TOL_LOSS = 1e-5
TOL_GRAD = 2e-4
TOL_STEP = 2e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _torch_tree_to_np(tree):
    return trainer.tree_map(lambda t: t.detach().float().numpy(), tree)


def _assert_trees_close(got, want, tol, what):
    """`got`: a port tree, or its leaves in tree order."""
    leaves = got if isinstance(got, list) else trainer.tree_leaves(got)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(leaves)
    for (path, w), g in zip(flat, leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=f'{what} {path}')


def test_num_params_and_flops_match_reference_for_every_preset():
    assert set(llama.CONFIGS) == set(ref_llama.CONFIGS)
    for name, ref_config in ref_llama.CONFIGS.items():
        config = llama.CONFIGS[name]
        assert config.num_params() == ref_config.num_params(), name
        for seq in (512, 4096):
            assert (config.flops_per_token(seq)
                    == ref_config.flops_per_token(seq)), name
    # bench-8b: 1.359 B params at llama3-8b layer width.
    assert round(llama.CONFIGS['bench-8b'].num_params() / 1e9, 3) == 1.359
    params = llama.init_params(llama.CONFIGS['tiny'],
                               torch.Generator().manual_seed(0), 'cpu')
    assert (sum(t.numel() for t in trainer.tree_leaves(params))
            == llama.CONFIGS['tiny'].num_params())


def _batch(seed, b, s, vocab, padded=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    if padded:
        mask[0, s // 2:] = 0.0
        mask[1, : s // 4] = 0.0
    return tokens, mask


@pytest.mark.parametrize('impl,padded', [('dense', False), ('flash', False),
                                         ('flash', True)],
                         ids=['dense', 'flash', 'flash_padding_mask'])
def test_loss_fn_value_and_grads_match_reference(impl, padded):
    ref_config = dataclasses.replace(ref_llama.CONFIGS['tiny'],
                                     attention_impl=impl)
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    ref_params = ref_llama.init_params(ref_config, jax.random.key(5))
    tokens, mask = _batch(0, 2, 32, ref_config.vocab_size, padded)
    ref_batch = {'tokens': jnp.asarray(tokens), 'mask': jnp.asarray(mask)}
    want_loss, want_grads = jax.value_and_grad(ref_llama.loss_fn)(
        ref_params, ref_batch, ref_config)
    params = trainer.tree_map(lambda t: t.requires_grad_(True),
                              weights.from_jax_params(_np_tree(ref_params)))
    batch = {'tokens': torch.from_numpy(tokens).long(),
             'mask': torch.from_numpy(mask)}
    loss = llama.loss_fn(params, batch, config)
    grads = torch.autograd.grad(loss, trainer.tree_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL_LOSS, atol=TOL_LOSS)
    _assert_trees_close([g.numpy() for g in grads], want_grads, TOL_GRAD,
                        'grad')


def test_loss_fn_masks_the_last_position_and_padding():
    config = llama.CONFIGS['tiny']
    params = llama.init_params(config, torch.Generator().manual_seed(1),
                               'cpu')
    tokens = torch.from_numpy(_batch(1, 2, 16, config.vocab_size)[0]).long()
    full = llama.loss_fn(params, {'tokens': tokens}, config)
    ones = llama.loss_fn(params, {'tokens': tokens,
                                  'mask': torch.ones(2, 16)}, config)
    assert torch.equal(full, ones)
    # The last position has no target: changing its token moves nothing
    # but the loss at position 14 (whose target it is).
    mask = torch.ones(2, 16)
    mask[:, 14] = 0.0
    other = tokens.clone()
    other[:, -1] = (other[:, -1] + 1) % config.vocab_size
    a = llama.loss_fn(params, {'tokens': tokens, 'mask': mask}, config)
    b = llama.loss_fn(params, {'tokens': other, 'mask': mask}, config)
    assert torch.equal(a, b)


def _ref_state_and_step(cfg):
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    state = ref_trainer.make_train_state(cfg, mesh)
    return state, ref_trainer.make_train_step(cfg, mesh)


@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
def test_train_step_matches_reference(steps, mu_dtype):
    kw = dict(model='tiny', batch_size=2, seq_len=32, warmup_steps=1,
              learning_rate=1e-2, max_steps=10, mu_dtype=mu_dtype)
    ref_state, ref_step = _ref_state_and_step(ref_trainer.TrainerConfig(**kw))
    cfg = trainer.TrainerConfig(**kw)
    state = trainer.make_train_state(
        cfg, 'cpu', params=weights.from_jax_params(
            _np_tree(ref_state['params'])))
    step = trainer.make_train_step(cfg, 'cpu')
    for i in range(steps):
        tokens, mask = _batch(10 + i, 2, 32, 256, padded=i == 1)
        ref_state, want = ref_step(ref_state, {
            'tokens': jnp.asarray(tokens), 'mask': jnp.asarray(mask)})
        state, got = step(state, {'tokens': torch.from_numpy(tokens).long(),
                                  'mask': torch.from_numpy(mask)})
        np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                                   rtol=TOL_LOSS, atol=TOL_LOSS)
        np.testing.assert_allclose(float(got['grad_norm']),
                                   float(want['grad_norm']), rtol=TOL_GRAD,
                                   atol=TOL_GRAD)
        assert got['step'] == int(want['step']) == i + 1
    _assert_trees_close(_torch_tree_to_np(state['params']),
                        ref_state['params'], TOL_STEP, 'param')
    adam = ref_state['opt_state'][1][0]
    assert state['opt_state']['count'] == int(adam.count) == steps
    mu_want = torch.bfloat16 if mu_dtype else torch.float32
    assert all(t.dtype == mu_want
               for t in trainer.tree_leaves(state['opt_state']['mu']))
    _assert_trees_close(_torch_tree_to_np(state['opt_state']['mu']),
                        _np_tree(adam.mu), TOL_STEP, 'mu')
    _assert_trees_close(_torch_tree_to_np(state['opt_state']['nu']),
                        adam.nu, TOL_STEP, 'nu')


def test_schedule_matches_optax():
    for warmup, max_steps in ((1, 10), (5, 20), (0, 7), (10, 4)):
        cfg = trainer.TrainerConfig(learning_rate=3e-4, warmup_steps=warmup,
                                    max_steps=max_steps)
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
            decay_steps=max(max_steps, warmup + 1))
        opt = trainer.make_optimizer(cfg)
        for count in (0, 1, 2, 3, 5, 9, 10, 11, 25):
            np.testing.assert_allclose(opt.learning_rate(count),
                                       float(want(count)), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize('max_norm', [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(3)
    tree = {'a': rng.standard_normal((4, 5)).astype(np.float32),
            'b': rng.standard_normal(7).astype(np.float32)}
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update(jax.tree.map(jnp.asarray, tree), clip.init(tree))
    grads = [torch.from_numpy(tree[k]) for k in sorted(tree)]
    norm = trainer.global_norm(grads)
    np.testing.assert_allclose(float(norm),
                               float(optax.global_norm(tree)), rtol=1e-6)
    scale = trainer.clip_scale(norm, max_norm)
    assert (float(scale) == 1.0) == (max_norm == 100.0)
    for key, g in zip(sorted(tree), grads):
        np.testing.assert_allclose((g * scale).numpy(),
                                   np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7)


def test_fit_on_cpu_loss_falls():
    cfg = trainer.TrainerConfig(model='tiny', batch_size=4, seq_len=32,
                                max_steps=6, warmup_steps=1,
                                learning_rate=1e-2)
    lines = []
    res = loop.fit(cfg, 'cpu', log_every=2, log_fn=lines.append)
    losses = [h['loss'] for h in res['history']]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    assert res['final_step'] == 6 and res['state']['step'] == 6
    assert len(lines) == 3 and 'tokens/s=' in lines[0]
    assert res['history'][0]['mfu'] is not None   # PEAK_FLOPS['cpu']


def test_fit_and_main_refuse_what_is_not_ported(tmp_path):
    """Checkpoints are ported: a missing `--checkpoint` raises the
    reference's FileNotFoundError, an empty `--checkpoint-dir` starts
    from scratch and saves at the end. A mesh of more than one device
    and ring attention are still refused."""
    cfg = trainer.TrainerConfig(model='tiny', max_steps=1, batch_size=1,
                                seq_len=8)
    with pytest.raises(FileNotFoundError, match='No checkpoint'):
        loop.fit(cfg, 'cpu', init_checkpoint=str(tmp_path / 'absent'))
    with pytest.raises(FileNotFoundError, match='No checkpoint'):
        loop.main(['--device', 'cpu', '--checkpoint',
                   str(tmp_path / 'absent')])
    res = loop.main(['--device', 'cpu', '--max-steps', '1',
                     '--batch-size', '1', '--seq-len', '8',
                     '--checkpoint-dir', str(tmp_path / 'run')])
    assert res['final_step'] == 1
    assert os.listdir(tmp_path / 'run') == ['1']
    with pytest.raises(NotImplementedError, match='parallel slice'):
        loop.main(['--device', 'cpu', '--mesh', 'data=2,fsdp=-1'])
    with pytest.raises(NotImplementedError, match='parallel slice'):
        loop.main(['--device', 'cpu', '--attention', 'ring',
                   '--max-steps', '1', '--batch-size', '1',
                   '--seq-len', '8'])


def test_main_trains_on_cpu():
    res = loop.main(['--device', 'cpu', '--model', 'tiny', '--max-steps',
                     '2', '--batch-size', '2', '--seq-len', '16',
                     '--mesh', 'fsdp=-1,tensor=1', '--attention', 'flash'])
    assert res['final_step'] == 2 and len(res['history']) == 1


def test_trainer_pieces_on_cpu():
    cfg = trainer.TrainerConfig(model='tiny', batch_size=3, seq_len=8)
    batch = trainer.synthetic_batch(cfg, 'cpu')
    assert batch['tokens'].shape == (3, 8) and batch['mask'].shape == (3, 8)
    assert int(batch['tokens'].max()) < 256
    assert trainer.detect_chip('cpu') == 'cpu'
    assert trainer.PEAK_FLOPS['h100'] == 989e12
    config = llama.CONFIGS['bench-8b']
    assert trainer.mfu(1000.0, config, 4096, 989e12) == pytest.approx(
        1000.0 * config.flops_per_token(4096) / 989e12)
    assert cfg.model_config().attention_impl == 'dense'
    assert dataclasses.replace(cfg, attention_impl='flash').model_config(
    ).attention_impl == 'flash'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            trainer.make_train_state(cfg)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            loop.fit(cfg)
