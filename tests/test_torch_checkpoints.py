"""Port parity: HF checkpoint import and the safetensors format, on the CPU.

`skypilot_tpu_torch.checkpoints` against `skypilot_tpu.checkpoints`:
- `detect_config` gives the reference's config (field for field, the
  dtype mapped) on the same config.json variants, and refuses what the
  reference refuses;
- the reference's `hf_export.export_params` output (tiny, tiny-gemma,
  tiny-mistral, tiny-qwen, and bf16 tiny-gemma; several shards and an
  index) loads through the port's `load_params` equal, exactly, to
  `weights.from_jax_params` of the same params;
- the port's `write_safetensors` and `ShardedWriter` write files the
  reference's reader reads byte for byte, and byte-identical to the
  reference's writer's;
- a missing tensor, an unexpected tensor under strict mode and a non-HF
  directory each raise; the host peak stays O(largest tensor);
- `build_engine(checkpoint=)` and the server's `--checkpoint` serve the
  imported weights (greedy tokens equal an engine built from the same
  params).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import checkpoints as ref_ckpt
from skypilot_tpu.checkpoints import safetensors_io as ref_st
from skypilot_tpu.models import gemma as ref_gemma
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu.models import mistral as ref_mistral
from skypilot_tpu.models import qwen as ref_qwen
from skypilot_tpu_torch import checkpoints as ckpt
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.checkpoints import hf_import
from skypilot_tpu_torch.checkpoints import safetensors_io as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FAMILIES = {'tiny': ref_llama, 'tiny-gemma': ref_gemma,
             'tiny-mistral': ref_mistral, 'tiny-qwen': ref_qwen}


def _ref_config(name, bf16=False):
    config = _FAMILIES[name].CONFIGS[name]
    return dataclasses.replace(config, dtype=jnp.bfloat16) if bf16 else config


def _port_config(ref_config):
    return weights.config_from_dict(dataclasses.asdict(ref_config))


def _export(tmp_path, ref_config, seed=3, max_shard_bytes=40_000):
    """The reference's params for `ref_config` and their HF export (the
    tiny models split over several shards with an index)."""
    # Every family's init_params is the shared llama core's.
    params = jax.tree.map(np.asarray, ref_llama.init_params(
        ref_config, jax.random.key(seed)))
    out = str(tmp_path / 'hf')
    ref_ckpt.export_params(params, ref_config, out,
                           max_shard_bytes=max_shard_bytes)
    return params, out


def _assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree_equal(got[key], want[key])
        else:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


# -- config.json -> LlamaConfig ----------------------------------------------

_BASE = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64,
             rope_theta=10000.0, rms_norm_eps=1e-6, torch_dtype='bfloat16')
CONFIG_VARIANTS = {
    'llama': {'model_type': 'llama', **_BASE},
    'llama_f32_tied': {'model_type': 'llama', **_BASE,
                       'torch_dtype': 'float32',
                       'tie_word_embeddings': True},
    'llama3_rope': {'model_type': 'llama', **_BASE, 'rope_scaling': {
        'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
        'high_freq_factor': 4.0,
        'original_max_position_embeddings': 8192}},
    'gemma': {'model_type': 'gemma', **_BASE, 'head_dim': 16},
    'gemma2': {'model_type': 'gemma2', **_BASE, 'head_dim': 16},
    'gemma2_null_softcaps': {'model_type': 'gemma2', **_BASE,
                             'head_dim': 16, 'attn_logit_softcapping': None,
                             'final_logit_softcapping': None,
                             'sliding_window': None},
    'gemma2_untied_qpa': {'model_type': 'gemma2', **_BASE, 'head_dim': 16,
                          'tie_word_embeddings': False,
                          'query_pre_attn_scalar': 144,
                          'sliding_window': 32},
    'mistral': {'model_type': 'mistral', **_BASE, 'sliding_window': 32},
    'qwen2': {'model_type': 'qwen2', **_BASE},
    'qwen2_window': {'model_type': 'qwen2', **_BASE,
                     'use_sliding_window': True, 'sliding_window': 24},
}
REFUSED_VARIANTS = {
    'unknown_family': {'model_type': 'mamba', **_BASE},
    'missing_geometry': {k: v for k, v in CONFIG_VARIANTS['llama'].items()
                         if k != 'intermediate_size'},
    'rope_scaling_on_mistral': {'model_type': 'mistral', **_BASE,
                                'rope_scaling': {'rope_type': 'llama3',
                                                 'factor': 8.0}},
    'rope_scaling_without_factor': {'model_type': 'llama', **_BASE,
                                    'rope_scaling': {'rope_type': 'llama3'}},
}


def _config_dir(tmp_path, cfg):
    d = tmp_path / 'cfg'
    d.mkdir(exist_ok=True)
    (d / 'config.json').write_text(json.dumps(cfg))
    return str(d)


@pytest.mark.parametrize('variant', list(CONFIG_VARIANTS))
def test_detect_config_matches_reference(tmp_path, variant):
    path = _config_dir(tmp_path, CONFIG_VARIANTS[variant])
    ref_family, ref_config = ref_ckpt.detect_config(path)
    family, config = ckpt.detect_config(path)
    assert family == ref_family
    assert config == _port_config(ref_config)
    assert ckpt.infer_family(config) == ref_ckpt.infer_family(ref_config)


@pytest.mark.parametrize('variant', list(REFUSED_VARIANTS))
def test_detect_config_refuses_what_the_reference_refuses(tmp_path, variant):
    path = _config_dir(tmp_path, REFUSED_VARIANTS[variant])
    with pytest.raises(ref_ckpt.HFImportError):
        ref_ckpt.detect_config(path)
    with pytest.raises(ckpt.HFImportError):
        ckpt.detect_config(path)


# -- the reference's export, the port's import -------------------------------

@pytest.mark.parametrize('name,bf16', [
    ('tiny', False), ('tiny-gemma', False), ('tiny-mistral', False),
    ('tiny-qwen', False), ('tiny-gemma', True)])
def test_reference_export_loads_equal_to_from_jax_params(tmp_path, name,
                                                         bf16):
    ref_config = _ref_config(name, bf16)
    params, out = _export(tmp_path, ref_config)
    assert os.path.exists(os.path.join(out, st.INDEX_FILENAME))
    got, config, stats = ckpt.load_params(out, device='cpu')
    # The detected config (remat and attention_impl at their defaults, as
    # the reference detects them), not the preset.
    assert config == _port_config(ref_ckpt.detect_config(out)[1])
    assert config.num_layers == ref_config.num_layers
    _assert_tree_equal(got, weights.from_jax_params(params, config))
    assert stats.shards > 1
    assert stats.tensors == len(hf_import.expected_hf_names(config))


def test_host_peak_stays_tensor_bounded(tmp_path, monkeypatch):
    """Layer by layer: with one read-ahead thread the host never holds
    more than the largest transformed tensor; with two, two of them."""
    _, out = _export(tmp_path, _ref_config('tiny'))
    _, _, one = ckpt.load_params(out, device='cpu', concurrency=1)
    assert one.peak_host_bytes == one.largest_tensor_bytes
    monkeypatch.setenv('SKYTPU_HF_IMPORT_CONCURRENCY', '2')
    got, config, two = ckpt.load_params(out, device='cpu')
    assert 0 < two.peak_host_bytes <= 2 * two.largest_tensor_bytes
    params = ckpt.load_params(out, device='cpu', concurrency=1)[0]
    _assert_tree_equal(got, params)


# -- the format, both ways ---------------------------------------------------

def _mixed_tensors():
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    return {
        'a.f32': f32,
        'b.bf16': np.asarray(bf),
        'c.i8': rng.integers(-128, 127, (7,)).astype(np.int8),
        'd.f16': rng.standard_normal((2, 2)).astype(np.float16),
        'e.i64': np.arange(3, dtype=np.int64),
    }


def test_port_writer_output_is_the_reference_writers_bytes(tmp_path):
    arrays = _mixed_tensors()
    as_torch = {k: weights.to_tensor(v) for k, v in arrays.items()}
    ref_path, port_path = tmp_path / 'ref.st', tmp_path / 'port.st'
    meta = {'format': 'pt'}
    ref_st.write_safetensors(str(ref_path), arrays, meta)
    st.write_safetensors(str(port_path), as_torch, meta)
    assert port_path.read_bytes() == ref_path.read_bytes()
    with ref_st.SafeTensorsFile(str(port_path)) as f:
        assert f.metadata == meta
        for name, want in arrays.items():
            got = f.tensors[name].read()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
            del got  # a live view keeps the mmap from closing
    # And the port reads the reference's file back to the same tensors.
    with st.SafeTensorsFile(str(ref_path)) as f:
        for name, want in as_torch.items():
            lazy = f.tensors[name]
            assert torch.equal(st.to_torch(lazy.read().copy(), lazy.tag),
                               want)


def test_port_sharded_writer_matches_the_reference(tmp_path):
    arrays = _mixed_tensors()
    ref_w = ref_st.ShardedWriter(str(tmp_path / 'ref'), max_shard_bytes=64)
    port_w = st.ShardedWriter(str(tmp_path / 'port'), max_shard_bytes=64)
    for name, arr in arrays.items():
        ref_w.add(name, arr)
        port_w.add(name, weights.to_tensor(arr))
    written = port_w.close()
    assert written == ref_w.close()
    assert st.INDEX_FILENAME in written and len(written) > 2
    for fn in written:
        assert ((tmp_path / 'port' / fn).read_bytes()
                == (tmp_path / 'ref' / fn).read_bytes()), fn
    with ref_st.CheckpointReader(str(tmp_path / 'port')) as reader:
        assert reader.names() == sorted(arrays)


def test_reader_validates_headers_and_names_the_nearest_tensor(tmp_path):
    path = tmp_path / 'one.safetensors'
    st.write_safetensors(str(path), {'model.norm.weight': np.ones(4,
                                                                  np.float32)})
    with st.CheckpointReader(str(path)) as reader:
        with pytest.raises(KeyError, match='model.norm.weight'):
            reader.tensor('model.norm.weights')
    raw = path.read_bytes()
    path.write_bytes(raw[:-4])                 # a truncated payload
    with pytest.raises(st.CheckpointFormatError, match='truncated'):
        st.CheckpointReader(str(path))


# -- refusals ----------------------------------------------------------------

def test_missing_tensor_raises(tmp_path):
    _, out = _export(tmp_path, _ref_config('tiny'), max_shard_bytes=1 << 30)
    shard = os.path.join(out, 'model.safetensors')
    with st.SafeTensorsFile(shard) as f:
        kept = {n: st.to_torch(t.read().copy(), t.tag)
                for n, t in f.tensors.items()
                if n != 'model.layers.1.mlp.up_proj.weight'}
    st.write_safetensors(shard, kept)
    with pytest.raises(ckpt.HFImportError,
                       match=r'missing 1 .*layers\.1\.mlp\.up_proj'):
        ckpt.load_params(out, device='cpu')


def test_unexpected_tensor_raises_under_strict(tmp_path, monkeypatch):
    _, out = _export(tmp_path, _ref_config('tiny'), max_shard_bytes=1 << 30)
    st.write_safetensors(os.path.join(out, 'extra.safetensors'),
                         {'model.layers.0.self_attn.rotary.bias':
                          np.zeros(2, np.float32)})
    monkeypatch.setenv('SKYTPU_HF_IMPORT_STRICT', '1')
    with pytest.raises(ckpt.HFImportError, match='unexpected'):
        ckpt.load_params(out, device='cpu')
    monkeypatch.setenv('SKYTPU_HF_IMPORT_STRICT', '0')
    params, _, _ = ckpt.load_params(out, device='cpu')
    assert set(params['layers']) >= {'wq', 'w_down'}


def test_non_hf_directory_raises(tmp_path):
    orbax_like = tmp_path / 'ckpt' / '100'
    orbax_like.mkdir(parents=True)
    (orbax_like / '_METADATA').write_text('{}')
    assert not ckpt.is_hf_checkpoint(str(tmp_path / 'ckpt'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        inference.build_engine('tiny', device='cpu',
                               checkpoint=str(tmp_path / 'ckpt'))
    shards_only = tmp_path / 'shards'
    shards_only.mkdir()
    st.write_safetensors(str(shards_only / 'model.safetensors'),
                         {'x': np.zeros(1, np.float32)})
    assert ckpt.is_hf_checkpoint(str(shards_only))
    with pytest.raises(ckpt.HFImportError, match='config.json'):
        ckpt.load_params(str(shards_only), device='cpu')


# -- serving an imported checkpoint ------------------------------------------

ENGINE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8)
PROMPT = [3, 14, 15, 92, 65, 35, 89, 79, 32, 38, 46, 26, 43, 38, 32, 79,
          50, 28, 84, 19]


def _greedy(engine, prompt, max_new=8):
    rid = engine.submit(list(prompt), inference.SamplingParams(
        temperature=0.0, max_new_tokens=max_new))
    return engine.run_to_completion()[rid]


@pytest.fixture(scope='module')
def gemma_checkpoint(tmp_path_factory):
    """tiny-gemma exported by the reference, and the greedy tokens of an
    engine built on the same params (no checkpoint involved)."""
    tmp = tmp_path_factory.mktemp('gemma_ckpt')
    ref_config = _ref_config('tiny-gemma')
    params, out = _export(tmp, ref_config, seed=7)
    config = _port_config(ref_config)
    direct = inference.InferenceEngine(
        weights.from_jax_params(params, config), config, device='cpu',
        **ENGINE_KW)
    return out, _greedy(direct, PROMPT)


def test_build_engine_serves_the_checkpoint(gemma_checkpoint):
    out, want = gemma_checkpoint
    # config.json wins over the preset named.
    engine = inference.build_engine('tiny', device='cpu', checkpoint=out,
                                    **ENGINE_KW)
    assert engine.config.norm_plus_one and engine.config.post_norms
    assert _greedy(engine, PROMPT) == want
    spec = inference.build_engine('tiny', device='cpu', checkpoint=out,
                                  draft_model='tiny',
                                  draft_checkpoint=out, **ENGINE_KW)
    assert spec.state.draft_cache is not None
    assert _greedy(spec, PROMPT) == want


def test_server_checkpoint_flag_serves_the_checkpoint(gemma_checkpoint,
                                                      tmp_path):
    out, want = gemma_checkpoint
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    log = open(tmp_path / 'server.log', 'w')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
         '--device', 'cpu', '--model', 'tiny', '--checkpoint', out,
         '--port', str(port), '--batch-size', '2', '--max-seq-len', '64',
         '--prefill-chunk', '16', '--kv-page-size', '8'],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, 'PYTHONPATH': REPO, 'OMP_NUM_THREADS': '1'})
    base = f'http://127.0.0.1:{port}'
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, (tmp_path / 'server.log').read_text()
            try:
                urllib.request.urlopen(base + '/health', timeout=2)
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.time() < deadline, 'the server never loaded'
                time.sleep(0.1)
        req = urllib.request.Request(
            base + '/generate', data=json.dumps({
                'prompt_tokens': PROMPT, 'max_new_tokens': 8}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())['tokens'] == want
    finally:
        proc.kill()
        proc.wait()
        log.close()
