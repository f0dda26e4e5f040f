"""Port parity: training checkpoints, resume and the fine-tune start.

`skypilot_tpu_torch.train.checkpoints` and `train.loop.fit` on the CPU,
tiny in f32, against the reference's `skypilot_tpu.train` where the two
can meet (each writes its own format: Orbax there, the port's
safetensors groups here):
- save and restore are exact (params, both moments, count and step),
  into a state on another device placement;
- a step without its sentinel is never resumed; an async save becomes
  visible after `flush`, holding the state as it was at the call;
- a `fit` stopped at step k and resumed gives per-step losses equal to
  an uninterrupted run's, exactly;
- from the same initial params (the reference's HF export, as
  `init_checkpoint`), the port's stopped-and-resumed losses match the
  reference's stopped-and-resumed `fit` within the train-parity
  tolerance of tests/test_torch_train.py (loss 1e-5);
- a geometry mismatch raises the reference's message;
- an armed `checkpoint.save` fault is retried under `RetryPolicy`, and
  the port's `retries.call` keeps the reference's schedule.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import checkpoints as ref_ckpts
from skypilot_tpu.models import gemma as ref_gemma
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.parallel import MeshSpec, make_mesh
from skypilot_tpu.resilience import retries as ref_retries
from skypilot_tpu.train import loop as ref_loop
from skypilot_tpu.train import trainer as ref_trainer
from skypilot_tpu_torch import inference
from skypilot_tpu_torch.resilience import faults
from skypilot_tpu_torch.resilience import retries
from skypilot_tpu_torch.train import checkpoints
from skypilot_tpu_torch.train import loop
from skypilot_tpu_torch.train import trainer

TOL_LOSS = 1e-5   # tests/test_torch_train.py
KW = dict(model='tiny', batch_size=2, seq_len=16, warmup_steps=1,
          learning_rate=1e-2)


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()


def _tokens(i, b=2, s=16):
    rng = np.random.default_rng(100 + i)
    return rng.integers(0, 256, (b, s)).astype(np.int32)


def _port_batch(i):
    return {'tokens': torch.from_numpy(_tokens(i)).long(),
            'mask': torch.ones((2, 16), dtype=torch.float32)}


def _trained_state(cfg, steps=2, seed=0):
    state = trainer.make_train_state(cfg, 'cpu', seed=seed)
    step = trainer.make_train_step(cfg, 'cpu')
    for i in range(steps):
        state, _ = step(state, _port_batch(i))
    return state


def _leaves(state):
    opt = state['opt_state']
    return (trainer.tree_leaves(state['params'])
            + trainer.tree_leaves(opt['mu']) + trainer.tree_leaves(opt['nu']))


@pytest.mark.parametrize('mu_dtype', [None, 'bfloat16'])
def test_save_and_restore_are_exact(tmp_path, mu_dtype):
    cfg = trainer.TrainerConfig(max_steps=10, mu_dtype=mu_dtype, **KW)
    state = _trained_state(cfg)
    path = checkpoints.save_train_state(str(tmp_path), state)
    assert path == str(tmp_path / '2') and checkpoints.latest_step(
        str(tmp_path)) == 2
    assert os.path.exists(tmp_path / '2' / checkpoints.COMPLETE_SENTINEL)
    fresh = trainer.make_train_state(cfg, 'cpu', seed=9)
    checkpoints.restore_train_state(str(tmp_path), fresh)
    assert fresh['step'] == 2 and fresh['opt_state']['count'] == 2
    for a, b in zip(_leaves(fresh), _leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # Params alone (the inference path), stacked again, with the named
    # model's config, as the reference restores an Orbax checkpoint; a
    # model the params do not fit is refused.
    params = checkpoints.restore_params(str(tmp_path), device='cpu')
    for a, b in zip(trainer.tree_leaves(params),
                    trainer.tree_leaves(state['params'])):
        assert torch.equal(a, b.detach())
    got, config = inference.restore_params(
        str(tmp_path), torch.device('cpu'), cfg.model_config())
    assert config == cfg.model_config()
    for a, b in zip(trainer.tree_leaves(got), trainer.tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='params do not fit the config'):
        inference.restore_params(
            str(tmp_path), torch.device('cpu'),
            trainer.TrainerConfig(model='llama3-8b').model_config())
    # A state of another geometry is refused, tensor named.
    other = trainer.make_train_state(dataclasses.replace(
        cfg, model='tiny-gemma'), 'cpu')
    with pytest.raises(ValueError, match='does not hold this state'):
        checkpoints.restore_train_state(str(tmp_path), other)
    with pytest.raises(ValueError, match='params do not fit the config'):
        checkpoints.restore_params(
            str(tmp_path), dataclasses.replace(cfg.model_config(),
                                               num_layers=3), 'cpu')


def test_torn_steps_are_never_resumed(tmp_path):
    cfg = trainer.TrainerConfig(max_steps=10, **KW)
    state = _trained_state(cfg, steps=1)
    for step in (1, 2, 3):
        checkpoints.save_train_state(str(tmp_path), state, step=step)
    os.remove(tmp_path / '3' / checkpoints.COMPLETE_SENTINEL)
    (tmp_path / '7').mkdir()                       # killed before a byte
    (tmp_path / 'notes').mkdir()
    assert checkpoints.latest_step(str(tmp_path)) == 2
    os.remove(tmp_path / '2' / checkpoints.COMPLETE_SENTINEL)
    os.remove(tmp_path / '1' / checkpoints.COMPLETE_SENTINEL)
    assert checkpoints.latest_step(str(tmp_path)) is None
    assert checkpoints.latest_step(str(tmp_path / 'absent')) is None
    with pytest.raises(FileNotFoundError, match='No checkpoint'):
        checkpoints.restore_train_state(
            str(tmp_path), trainer.make_train_state(cfg, 'cpu'))
    # A resumed fit starts from scratch rather than from a torn step.
    logs = []
    loop.fit(dataclasses.replace(cfg, max_steps=1), 'cpu',
             checkpoint_dir=str(tmp_path), log_fn=logs.append)
    assert not any('resumed' in line for line in logs)


def test_async_save_becomes_visible_after_flush(tmp_path, monkeypatch):
    cfg = trainer.TrainerConfig(max_steps=10, **KW)
    state = _trained_state(cfg)
    want = [t.detach().clone() for t in _leaves(state)]
    checkpoints.save_train_state(str(tmp_path), state, step=2, wait=False)
    # The step mutates the state in place right after the call.
    state, _ = trainer.make_train_step(cfg, 'cpu')(state, _port_batch(5))
    checkpoints.flush()
    assert checkpoints.latest_step(str(tmp_path)) == 2
    fresh = trainer.make_train_state(cfg, 'cpu', seed=4)
    checkpoints.restore_train_state(str(tmp_path), fresh)
    for a, b in zip(_leaves(fresh), want):
        assert torch.equal(a, b)
    # An error in the background save surfaces at flush, and its step
    # never becomes a resume candidate.

    def full_disk(path, groups, meta):
        raise OSError('No space left on device')
    monkeypatch.setattr(checkpoints, '_write_step', full_disk)
    checkpoints.save_train_state(str(tmp_path), state, step=3, wait=False)
    with pytest.raises(OSError, match='No space'):
        checkpoints.flush()
    checkpoints.flush()   # reported once
    assert checkpoints.latest_step(str(tmp_path)) == 2


def _losses(history):
    return [h['loss'] for h in history]


class _Preempted(Exception):
    pass


def test_resumed_fit_equals_an_uninterrupted_one(tmp_path):
    """A run killed after step 3 (saves every step) and relaunched with
    the same arguments, as a managed job is, continues the uninterrupted
    run exactly: losses of steps 4-5 and the final state."""
    run = str(tmp_path / 'run')
    cfg = trainer.TrainerConfig(max_steps=5, **KW)
    whole = loop.fit(cfg, 'cpu', batch_fn=_port_batch, log_every=1,
                     log_fn=lambda s: None)

    def killed_at_4(i):
        if i == 3:
            raise _Preempted
        return _port_batch(i)
    with pytest.raises(_Preempted):
        loop.fit(cfg, 'cpu', batch_fn=killed_at_4, checkpoint_dir=run,
                 checkpoint_every=1, log_every=1, log_fn=lambda s: None)
    assert checkpoints.latest_step(run) == 3
    logs = []
    rest = loop.fit(cfg, 'cpu', batch_fn=_port_batch, checkpoint_dir=run,
                    checkpoint_every=1, log_every=1, log_fn=logs.append)
    assert logs[0] == '[fit] resumed from step 3'
    assert [h['step'] for h in rest['history']] == [4, 5]
    assert _losses(rest['history']) == _losses(whole['history'])[3:]
    assert sorted(os.listdir(run)) == ['1', '2', '3', '4', '5']
    for a, b in zip(_leaves(rest['state']), _leaves(whole['state'])):
        assert torch.equal(a, b)


def _ref_mesh():
    return make_mesh(MeshSpec(), devices=jax.devices()[:1])


def _ref_fit(monkeypatch, cfg, **kw):
    """The reference's fit, every step's loss recorded."""
    losses = []
    make = ref_trainer.make_train_step

    def recording(cfg_, mesh_):
        step = make(cfg_, mesh_)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics['loss']))
            return state, metrics
        return run

    monkeypatch.setattr(ref_loop.trainer_lib, 'make_train_step', recording)

    def batch_fn(i):
        return {'tokens': jnp.asarray(_tokens(i)),
                'mask': jnp.ones((2, 16), jnp.float32)}
    ref_loop.fit(cfg, _ref_mesh(), batch_fn=batch_fn, log_fn=lambda s: None,
                 **kw)
    return losses


def test_resumed_losses_match_the_reference_fit(tmp_path, monkeypatch):
    """Both packages fine-tune the reference's HF export of the same
    params for 2 steps, stop, and resume to 4, each in its own
    checkpoint format."""
    ref_config = ref_llama.CONFIGS['tiny']
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        ref_config, jax.random.key(21)))
    hf = str(tmp_path / 'hf')
    ref_ckpts.export_params(params, ref_config, hf)
    want, got = [], []
    for max_steps in (2, 4):
        want += _ref_fit(monkeypatch, ref_trainer.TrainerConfig(
            max_steps=4, **KW) if max_steps == 4 else
            ref_trainer.TrainerConfig(max_steps=2, **KW),
            checkpoint_dir=str(tmp_path / 'ref'), checkpoint_every=2,
            init_checkpoint=hf)
        res = loop.fit(trainer.TrainerConfig(max_steps=max_steps, **KW),
                       'cpu', batch_fn=_port_batch,
                       checkpoint_dir=str(tmp_path / 'port'),
                       checkpoint_every=2, init_checkpoint=hf, log_every=1,
                       log_fn=lambda s: None)
        got += _losses(res['history'])
    assert len(want) == len(got) == 4
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS, atol=TOL_LOSS)
    assert got[3] < got[0]
    # The reference's Orbax directory is refused by name, not misread.
    assert checkpoints.is_orbax_checkpoint(str(tmp_path / 'ref'))
    with pytest.raises(NotImplementedError, match='Orbax'):
        checkpoints.restore_params(str(tmp_path / 'ref'), device='cpu')


def test_geometry_mismatch_raises_the_reference_message(tmp_path,
                                                         monkeypatch):
    gemma = ref_gemma.CONFIGS['tiny-gemma']
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        gemma, jax.random.key(2)))
    hf = str(tmp_path / 'gemma')
    ref_ckpts.export_params(params, gemma, hf)
    head = (f'--checkpoint geometry mismatch: {hf!r} does not hold params '
            "for model 'tiny' (different family knobs")
    with pytest.raises(ValueError) as want:
        _ref_fit(monkeypatch, ref_trainer.TrainerConfig(max_steps=1, **KW),
                 init_checkpoint=hf)
    with pytest.raises(ValueError) as got:
        loop.fit(trainer.TrainerConfig(max_steps=1, **KW), 'cpu',
                 init_checkpoint=hf)
    assert str(want.value).startswith(head)
    assert str(got.value).startswith(head)


def test_armed_save_fault_is_retried(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_CKPT_RETRY_GAP', '0')
    cfg = trainer.TrainerConfig(max_steps=2, **KW)
    faults.arm('checkpoint.save', times=2)
    loop.fit(cfg, 'cpu', checkpoint_dir=str(tmp_path), checkpoint_every=2,
             log_fn=lambda s: None)
    assert faults.hits('checkpoint.save') == 2
    assert checkpoints.latest_step(str(tmp_path)) == 2
    faults.arm('checkpoint.save', times=3)
    with pytest.raises(faults.FaultInjected):
        loop.fit(dataclasses.replace(cfg, max_steps=4), 'cpu',
                 checkpoint_dir=str(tmp_path), checkpoint_every=2,
                 log_fn=lambda s: None)
    assert checkpoints.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize('policy,failures', [
    (dict(max_attempts=3, base_delay=2.0, max_delay=30.0), 2),
    (dict(max_attempts=3, base_delay=2.0, max_delay=30.0), 5),
    (dict(max_attempts=None, base_delay=1.0, max_delay=4.0,
          deadline=10.0), 9),
    (dict(max_attempts=4, base_delay=1.0, max_delay=8.0, jitter=False,
          exponential=False), 2),
], ids=['recovers', 'exhausted', 'deadline', 'flat'])
def test_retry_schedule_matches_the_reference(policy, failures):
    def run(mod):
        clock = [0.0]
        sleeps, retried = [], []
        left = [failures]

        def flaky():
            if left[0]:
                left[0] -= 1
                raise OSError('blip')
            return 'ok'

        def sleep(s):
            sleeps.append(s)
            clock[0] += s
        try:
            out = mod.call(flaky, policy=mod.RetryPolicy(**policy),
                           retry_on=(OSError,),
                           on_retry=lambda e, n: retried.append(n),
                           sleep_fn=sleep, now_fn=lambda: clock[0],
                           rng=lambda: 0.75)
        except OSError:
            out = 'raised'
        return out, sleeps, retried
    assert run(retries) == run(ref_retries)
    with pytest.raises(ValueError):
        retries.RetryPolicy(max_attempts=None)
    decorated = retries.retrying(retries.RetryPolicy(
        max_attempts=2, base_delay=0.0, max_delay=0.0))(
            lambda: json.dumps({}))
    assert decorated() == '{}'
