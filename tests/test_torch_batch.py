"""Port parity: offline batch inference (`inference/batch.py`).

- The port's `run_batch` against the JAX package's on the same requests
  (more than the batch's slots, so slots recycle; per-line
  max_new_tokens, eos and ids) and the same tiny f32 weights: the
  records are equal.
- `main` as a process with `--device cpu`, reading an HF checkpoint and
  a port train checkpoint: its JSONL equals `run_batch` in this process
  on an engine built from the same flags (`engine_kwargs`).
- Requests that never finish raise; an empty input exits; a mesh of
  more than one device raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import batch as ref_batch
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu_torch import checkpoints
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import batch
from skypilot_tpu_torch.train import checkpoints as train_ckpts
from skypilot_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, kv_quant='none', decode_fuse_steps=2,
                 prefill_interleave=0)
FLAGS = ['--batch-size', '2', '--max-seq-len', '64', '--kv-page-size',
         '8', '--kv-quant', 'none', '--decode-fuse-steps', '2',
         '--max-new-tokens', '5']


def _requests():
    rng = np.random.default_rng(11)
    reqs = []
    for i, n in enumerate((5, 19, 3, 27, 11, 8)):
        req = {'prompt_tokens': [int(t) for t in rng.integers(1, 256, n)]}
        if i % 2:
            req['id'] = f'req-{i}'
        if i == 3:
            req['max_new_tokens'] = 9
        if i == 4:
            req['eos_token_id'] = 7
        reqs.append(req)
    return reqs


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def tiny():
    config = ref_llama.CONFIGS['tiny']
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        config, jax.random.key(3)))
    port_config = weights.config_from_dict(dataclasses.asdict(config))
    return config, params, port_config, weights.from_jax_params(
        params, port_config)


def test_run_batch_records_equal_the_reference(tiny):
    config, params, port_config, port_params = tiny
    reqs = _requests()
    want = ref_batch.run_batch(
        ref_inference.InferenceEngine(params, config, **ENGINE_KW), reqs,
        ref_inference.SamplingParams(temperature=0.0, max_new_tokens=5))
    got = batch.run_batch(
        inference.InferenceEngine(port_params, port_config, device='cpu',
                                  **ENGINE_KW), reqs,
        inference.SamplingParams(temperature=0.0, max_new_tokens=5))
    assert got == want
    assert [r['id'] for r in got] == [0, 'req-1', 2, 'req-3', 4, 'req-5']
    assert got[3]['num_tokens'] == 9


def _run_main(tmp_path, reqs, *flags):
    inp, out = tmp_path / 'in.jsonl', tmp_path / 'out.jsonl'
    inp.write_text(''.join(json.dumps(r) + '\n' for r in reqs))
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.batch',
         '--device', 'cpu', '--input', str(inp), '--output', str(out),
         *FLAGS, *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'})
    assert proc.returncode == 0, proc.stderr
    assert '[batch] 6 requests' in proc.stderr
    return out.read_text()


def _in_process(reqs, *flags):
    args = batch.build_parser().parse_args(
        ['--device', 'cpu', '--input', '-', '--output', '-', *FLAGS,
         *flags])
    engine = inference.build_engine(args.model, **batch.engine_kwargs(args))
    records = batch.run_batch(engine, reqs, inference.SamplingParams(
        temperature=args.temperature, top_k=args.top_k,
        max_new_tokens=args.max_new_tokens))
    return ''.join(json.dumps(r) + '\n' for r in records)


def test_main_reads_hf_and_train_checkpoints(tiny, tmp_path):
    _config, _params, port_config, port_params = tiny
    reqs = _requests()
    hf = tmp_path / 'hf'
    checkpoints.export_params(port_params, port_config, str(hf))
    # A train checkpoint of other params: each flag must serve its own.
    cfg = trainer.TrainerConfig(model='tiny')
    state = trainer.make_train_state(cfg, 'cpu', seed=5)
    train_dir = tmp_path / 'train'
    train_ckpts.save_train_state(str(train_dir), state, step=3)
    outs = {}
    # An HF dir's config.json wins over --model; a train checkpoint is
    # read with --model's geometry, which its params must fit.
    for name, ckpt, model in (('hf', hf, 'llama3-8b'),
                              ('train', train_dir, 'tiny')):
        flags = ('--model', model, '--checkpoint', str(ckpt))
        outs[name] = _run_main(tmp_path, reqs, *flags)
        assert outs[name] == _in_process(reqs, *flags)
    assert outs['hf'] != outs['train']
    with pytest.raises(ValueError, match='params do not fit the config'):
        _in_process(reqs, '--model', 'llama3-8b', '--checkpoint',
                    str(train_dir))
    direct = batch.run_batch(
        inference.InferenceEngine(port_params, port_config, device='cpu',
                                  **ENGINE_KW), reqs,
        inference.SamplingParams(temperature=0.0, max_new_tokens=5))
    assert outs['hf'] == ''.join(json.dumps(r) + '\n' for r in direct)


class _LosingEngine:
    """Finishes every request but the second."""

    def __init__(self):
        self.rids = []
        self.has_work = True

    def submit(self, prompt, sampling):
        self.rids.append(len(self.rids))
        return self.rids[-1]

    def run_to_completion(self):
        self.has_work = False
        return {rid: [1] for rid in self.rids if rid != 1}


def test_missing_requests_raise_and_empty_input_exits(tmp_path):
    reqs = [{'prompt_tokens': [1]}, {'prompt_tokens': [2], 'id': 'b'},
            {'prompt_tokens': [3]}]
    with pytest.raises(RuntimeError, match=r"1 requests never finished "
                       r"\(first few ids: \['b'\]\)"):
        batch.run_batch(_LosingEngine(), reqs, inference.SamplingParams())
    empty = tmp_path / 'empty.jsonl'
    empty.write_text('\n\n')
    with pytest.raises(SystemExit, match='No requests in'):
        batch.main(['--device', 'cpu', '--input', str(empty), '--output',
                    str(tmp_path / 'out.jsonl')])
    with pytest.raises(NotImplementedError, match='more than one device'):
        batch.main(['--device', 'cpu', '--input', str(empty), '--output',
                    str(tmp_path / 'out.jsonl'), '--mesh', 'tensor=2'])
