"""Request migration in the port: snapshot/restore, handoff, /internal/*.

The oracle is greedy token-for-token identity: a request snapshotted
mid-decode, aborted and restored into another engine emits exactly what
an uninterrupted run emits. Blobs are the reference's `SKTPUSNP` v1 byte
for byte, so they cross between the JAX engine and the port's in both
directions (dense, paged, int8 and bf16 caches), and every malformed
blob raises SnapshotError in both packages. `tiny` on the CPU, the
reference's weights through `weights.from_jax_params`; f32 unless a case
says bf16. The server cases drive the port's HTTP server: drain into a
migrate frame, restore on a second server, snapshot by key, and the
handoff's resume and abandon, with the reference's status codes and
bodies.
"""
import base64
import dataclasses
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import inference as ref_inference
from skypilot_tpu.inference import engine as ref_eng
from skypilot_tpu.models import llama as ref_llama
from skypilot_tpu_torch import inference
from skypilot_tpu_torch import weights
from skypilot_tpu_torch.inference import engine as port_eng
from skypilot_tpu_torch.inference import server as server_lib

_PROMPT = [3, 17, 42, 9, 105, 8]
_STEPS = 16


@pytest.fixture(scope='module')
def tiny():
    ref_config = ref_llama.CONFIGS['tiny']
    params = ref_llama.init_params(ref_config, jax.random.key(7))
    return _pair(ref_config, params)


def _pair(ref_config, params):
    config = weights.config_from_dict(dataclasses.asdict(ref_config))
    tparams = weights.from_jax_params(jax.tree.map(np.asarray, params),
                                      config)
    return ref_config, params, config, tparams


@pytest.fixture(scope='module')
def tiny_bf16(tiny):
    ref_config, params, _, _ = tiny
    ref_config = dataclasses.replace(ref_config, dtype=jnp.bfloat16)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    return _pair(ref_config, params)


_BASE_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                kv_quant='none', decode_fuse_steps=2)


def _port(tiny, **kw):
    _, _, config, tparams = tiny
    return inference.InferenceEngine(tparams, config, device='cpu',
                                     **{**_BASE_KW, **kw})


def _ref(tiny, **kw):
    ref_config, params, _, _ = tiny
    return ref_inference.InferenceEngine(params, ref_config,
                                         **{**_BASE_KW, **kw})


def _greedy(pkg, max_new=_STEPS):
    return pkg.SamplingParams(temperature=0.0, max_new_tokens=max_new)


def _pkg(eng):
    return (inference if isinstance(eng, inference.InferenceEngine)
            else ref_inference)


def _uninterrupted(eng, prompt=_PROMPT, steps=_STEPS):
    rid = eng.submit(list(prompt), _greedy(_pkg(eng), steps))
    return eng.run_to_completion()[rid]


def _drive_until(eng, rid, n_tokens):
    for _ in range(200):
        eng.step()
        assert rid not in eng.finished(), 'finished before the snapshot'
        prog = eng.active_progress()
        if len(prog.get(rid, ())) >= n_tokens:
            return list(prog[rid])
    raise AssertionError('never reached the snapshot point')


def _migrate(src, dst, mid=5, steps=_STEPS):
    rid = src.submit(list(_PROMPT), _greedy(_pkg(src), steps))
    mid_tokens = _drive_until(src, rid, mid)
    blob = src.snapshot_request(rid)
    src.abort(rid)
    rid2 = dst.restore_request(blob)
    final = dst.run_to_completion()[rid2]
    assert final[:len(mid_tokens)] == mid_tokens
    return final


# -- blobs cross between the packages ----------------------------------------

LAYOUTS = {'dense': dict(kv_page_size=0), 'paged': dict(kv_page_size=8),
           'int8': dict(kv_page_size=8, kv_quant='int8'),
           'bf16': dict(kv_page_size=8)}


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_blob_crosses_packages(tiny, tiny_bf16, layout, direction):
    pair = tiny_bf16 if layout == 'bf16' else tiny
    kw = LAYOUTS[layout]
    ref_tokens = _uninterrupted(_ref(pair, **kw))
    port_tokens = _uninterrupted(_port(pair, **kw))
    assert port_tokens == ref_tokens
    src, dst = ((_ref(pair, **kw), _port(pair, **kw))
                if direction == 'jax_to_port'
                else (_port(pair, **kw), _ref(pair, **kw)))
    assert _migrate(src, dst) == ref_tokens


def test_packing_is_byte_identical(tiny_bf16):
    """The same header and arrays pack to the same bytes in both
    packages, and each unpacks the other's."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((2, 3, 8, 2, 16)).astype(np.float32)
    bf16 = np.asarray(jnp.asarray(f32, jnp.bfloat16))
    q = rng.integers(-127, 128, (2, 3, 8, 2, 16)).astype(np.int8)
    header = {'fmt': 'skytpu-kv-snapshot', 'request_id': 3,
              'sampling': {'temperature': 0.0, 'top_k': 0},
              'logprobs': [-0.5, -1.25]}
    want = ref_eng._snapshot_pack(
        header, [('k', bf16), ('k.q', q), ('k.s', f32)])
    got = port_eng._snapshot_pack(header, [
        ('k', weights.to_tensor(bf16)), ('k.q', torch.from_numpy(q)),
        ('k.s', torch.from_numpy(f32))])
    assert got == want
    h, arrays = port_eng._snapshot_unpack(want)
    assert h['arrays'][0] == {'name': 'k', 'dtype': 'bfloat16',
                              'shape': [2, 3, 8, 2, 16]}
    assert arrays['k'].dtype == torch.bfloat16
    assert torch.equal(arrays['k'].float(), torch.from_numpy(
        np.array(jnp.asarray(bf16, jnp.float32))))
    _, ref_arrays = ref_eng._snapshot_unpack(got)
    np.testing.assert_array_equal(ref_arrays['k.q'], q)


def test_engine_blobs_agree_across_packages(tiny):
    """A queued request's host-only blob is byte-identical; a mid-decode
    blob has the same header and the same KV and logprobs within f32
    rounding (the two packages sum in different orders)."""
    blobs = {}
    for name, make in (('ref', _ref), ('port', _port)):
        eng = make(tiny, kv_page_size=8)
        for p in ([1, 2, 3], [4, 5, 6]):
            eng.submit(p, _greedy(_pkg(eng)))
        eng.step()
        queued = eng.submit(list(_PROMPT), _greedy(_pkg(eng)))
        blobs[name] = [eng.snapshot_request(queued)]
        _drive_until(eng, 0, 5)
        blobs[name].append(eng.snapshot_request(0))
    assert blobs['port'][0] == blobs['ref'][0]
    h_ref, a_ref = ref_eng._snapshot_unpack(blobs['ref'][1])
    h_port, a_port = port_eng._snapshot_unpack(blobs['port'][1])
    np.testing.assert_allclose(h_port.pop('logprobs'),
                               h_ref.pop('logprobs'), rtol=1e-4, atol=1e-4)
    assert h_port == h_ref
    for name, arr in a_ref.items():
        np.testing.assert_allclose(a_port[name].numpy(), arr, rtol=2e-4,
                                   atol=2e-4)


# -- malformed blobs ---------------------------------------------------------


def _forge_version(blob, magic):
    body = blob[len(magic):-4]
    _, hlen = struct.unpack_from('<II', body)
    body = struct.pack('<II', 2, hlen) + body[8:]
    return magic + body + struct.pack('<I', zlib.crc32(body))


def _flip(blob):
    out = bytearray(blob)
    out[len(out) // 2] ^= 0xFF
    return bytes(out)


FAULTS = {
    'truncated': (lambda b: b[:-7], {}),
    'truncated_head': (lambda b: b[:15], {}),
    'bit_flipped': (_flip, {}),
    'wrong_version': (lambda b: _forge_version(b, b'SKTPUSNP'), {}),
    'garbage': (lambda b: b'not a snapshot at all', {}),
    'wrong_page_size': (lambda b: b, dict(kv_page_size=4)),
    'wrong_max_seq_len': (lambda b: b, dict(max_seq_len=48)),
    'wrong_layout': (lambda b: b, dict(kv_page_size=0)),
    'wrong_dtype': (lambda b: b, dict(kv_quant='int8')),
}


@pytest.fixture(scope='module')
def good_blobs(tiny):
    out = {}
    for name, make in (('jax', _ref), ('port', _port)):
        src = make(tiny, kv_page_size=8)
        rid = src.submit(list(_PROMPT), _greedy(_pkg(src)))
        _drive_until(src, rid, 3)
        out[name] = src.snapshot_request(rid)
    return out


@pytest.mark.parametrize('fault', list(FAULTS))
@pytest.mark.parametrize('package', ['jax', 'port'])
def test_malformed_blob_raises_snapshot_error(tiny, good_blobs, package,
                                              fault):
    """Both packages refuse every fault, on their own blobs and on the
    other package's."""
    mutate, engine_kw = FAULTS[fault]
    errors = {'jax': ref_eng.SnapshotError, 'port': port_eng.SnapshotError}
    make = _ref if package == 'jax' else _port
    dst = make(tiny, **{'kv_page_size': 8, **engine_kw})
    for origin in ('jax', 'port'):
        with pytest.raises(errors[package]):
            dst.restore_request(mutate(good_blobs[origin]))
    assert not dst.has_work


# -- mirrored reference cases: engine to engine in the port ------------------


@pytest.mark.parametrize('kw', [
    dict(kv_page_size=8, prefix_cache=False),
    dict(kv_page_size=8, prefix_cache=True),
    dict(kv_page_size=8, kv_quant='int8'),
    dict(kv_page_size=0),
], ids=['paged_prefix_off', 'paged_prefix_on', 'int8', 'dense'])
def test_greedy_identity_port_to_port(tiny, kw):
    ref_tokens = _uninterrupted(_port(tiny, **kw))
    src, dst = _port(tiny, **kw), _port(tiny, **kw)
    if kw.get('prefix_cache'):
        # The migrated request admits with pages shared from the cache.
        _uninterrupted(src, steps=4)
    assert _migrate(src, dst) == ref_tokens


def test_roundtrip_spliced_pages_byte_equal(tiny):
    src = _port(tiny, kv_page_size=8, prefix_cache=False)
    dst = _port(tiny, kv_page_size=8, prefix_cache=False)
    rid = src.submit(list(_PROMPT), _greedy(inference))
    _drive_until(src, rid, 5)
    blob = src.snapshot_request(rid)
    blob2 = dst.snapshot_request(dst.restore_request(blob))
    h1, a1 = port_eng._snapshot_unpack(blob)
    h2, a2 = port_eng._snapshot_unpack(blob2)
    assert {k: v for k, v in h1.items() if k != 'request_id'} == \
        {k: v for k, v in h2.items() if k != 'request_id'}
    assert sorted(a1) == sorted(a2)
    for name in a1:
        assert torch.equal(a1[name], a2[name])


def test_size_cap_refuses_loudly(tiny, monkeypatch):
    monkeypatch.setenv('SKYTPU_MIGRATION_MAX_BYTES', '16')
    src = _port(tiny, kv_page_size=8)
    rid = src.submit(list(_PROMPT), _greedy(inference))
    _drive_until(src, rid, 3)
    with pytest.raises(port_eng.SnapshotError,
                       match='MIGRATION_MAX_BYTES'):
        src.snapshot_request(rid)


def test_queued_request_snapshots_host_only(tiny):
    src = _port(tiny, kv_page_size=8)
    for p in ([1, 2, 3], [4, 5, 6]):
        src.submit(p, _greedy(inference))
    src.step()
    rid = src.submit(list(_PROMPT), _greedy(inference))
    header, arrays = port_eng._snapshot_unpack(src.snapshot_request(rid))
    assert header['layout'] == 'none' and not arrays
    dst = _port(tiny, kv_page_size=8)
    rid2 = dst.restore_request(src.snapshot_request(rid))
    assert dst.run_to_completion()[rid2] == _uninterrupted(
        _port(tiny, kv_page_size=8))


def test_finished_request_not_snapshotable(tiny):
    src = _port(tiny, kv_page_size=8)
    rid = src.submit(list(_PROMPT), _greedy(inference, 4))
    src.run_to_completion()
    with pytest.raises(KeyError):
        src.snapshot_request(rid)


def test_pool_accounting_across_restore(tiny):
    src = _port(tiny, kv_page_size=8, prefix_cache=True)
    dst = _port(tiny, kv_page_size=8, prefix_cache=True)
    rid = src.submit(list(_PROMPT), _greedy(inference))
    _drive_until(src, rid, 5)
    blob = src.snapshot_request(rid)
    src.abort(rid)

    def accounted(eng):
        private = sum(len(pages) - len(eng._slot_shared[i])
                      for i, pages in enumerate(eng._slot_pages))
        return eng.pages_free() + eng.pages_cached() + private

    rid2 = dst.restore_request(blob)
    assert accounted(dst) == dst.pages_total()
    assert rid2 in dst.run_to_completion()
    assert accounted(dst) == dst.pages_total()
    assert accounted(src) == src.pages_total()


def test_restore_refuses_when_full_then_fits(tiny):
    src = _port(tiny, kv_page_size=8)
    rid = src.submit(list(_PROMPT), _greedy(inference))
    _drive_until(src, rid, 5)
    blob = src.snapshot_request(rid)
    dst = _port(tiny, kv_page_size=8)
    occupants = [dst.submit(p, _greedy(inference)) for p in ([1, 2, 3],
                                                             [4, 5, 6])]
    dst.step()
    with pytest.raises(RuntimeError, match='no free slot'):
        dst.restore_request(blob)
    for o in occupants:
        dst.abort(o)
    assert dst.restore_request(blob) in dst.run_to_completion()


# -- planned handoff ---------------------------------------------------------


def _drive_to_pause(eng, rid):
    for _ in range(200):
        eng.step()
        for s in eng.state.slots:
            if s is not None and s.request_id == rid and s.handoff_pause:
                assert s.generated
                return list(s.generated)
        assert rid not in eng.finished()
    raise AssertionError('never paused at the prefill->decode boundary')


@pytest.mark.parametrize('direction', ['port_to_port', 'port_to_jax'])
def test_handoff_pauses_at_first_token_and_restores(tiny, direction):
    ref_tokens = _uninterrupted(_port(tiny, kv_page_size=8))
    src = _port(tiny, kv_page_size=8)
    dst = (_port if direction == 'port_to_port' else _ref)(
        tiny, kv_page_size=8)
    rid = src.submit(list(_PROMPT), _greedy(inference), handoff=True)
    mid = _drive_to_pause(src, rid)
    assert len(mid) == 1 and src.handoff_pending() == [rid]
    src.mark_handoff_exported(rid)
    assert src.handoff_pending() == []
    blob = src.snapshot_request(rid)
    assert port_eng._snapshot_unpack(blob)[0]['layout'] == 'paged'
    src.abort(rid)
    assert src.pages_free() + src.pages_cached() == src.pages_total()
    rid2 = dst.restore_request(blob)
    assert dst.run_to_completion()[rid2] == ref_tokens


def test_paused_slot_does_not_decode_and_resume_is_idempotent(
        tiny, monkeypatch):
    monkeypatch.setenv('SKYTPU_HANDOFF_LEASE_SECONDS', '30')
    eng = _port(tiny, kv_page_size=8)
    rid = eng.submit(list(_PROMPT), _greedy(inference), handoff=True)
    mid = _drive_to_pause(eng, rid)
    for _ in range(4):
        eng.step()
    assert eng.active_progress()[rid] == mid
    assert eng.has_work and not eng.has_runnable_work
    assert eng.resume_handoff(rid)
    assert not eng.resume_handoff(rid)
    assert eng.run_to_completion()[rid] == _uninterrupted(
        _port(tiny, kv_page_size=8))
    assert not eng.resume_handoff(rid)
    assert eng.stats['handoff_fallbacks'] == 0


def test_lease_expiry_resumes_locally(tiny, monkeypatch):
    monkeypatch.setenv('SKYTPU_HANDOFF_LEASE_SECONDS', '0.15')
    eng = _port(tiny, kv_page_size=8)
    rid = eng.submit(list(_PROMPT), _greedy(inference), handoff=True)
    mid = _drive_to_pause(eng, rid)
    assert len(mid) < _STEPS
    time.sleep(0.2)
    assert eng.run_to_completion()[rid] == _uninterrupted(
        _port(tiny, kv_page_size=8))
    assert eng.stats['handoff_fallbacks'] == 1


def test_abort_racing_handoff_leaves_nothing(tiny):
    eng = _port(tiny, kv_page_size=8)
    rid = eng.submit(list(_PROMPT), _greedy(inference), handoff=True)
    _drive_to_pause(eng, rid)
    eng.abort(rid)
    assert not eng.resume_handoff(rid) and eng.handoff_pending() == []
    assert not eng._handoff_deadline and not eng.has_work
    assert eng.pages_free() + eng.pages_cached() == eng.pages_total()


# -- the server's internal endpoints -----------------------------------------

SERVER_KW = dict(batch_size=2, max_seq_len=64, prefill_chunk=16,
                 kv_page_size=8, decode_fuse_steps=2, device='cpu', seed=1)
_SERVER_PROMPT = list(range(7, 19))


class _Server:
    """One port server over a `tiny` engine, optionally throttled so a
    drain lands mid-stream."""

    def __init__(self, throttle: float = 0.0):
        self.engine = inference.build_engine('tiny', **SERVER_KW)
        if throttle:
            step = self.engine.step

            def slow_step():
                time.sleep(throttle)
                step()
            self.engine.step = slow_step
        self.holder = {'loop': server_lib.EngineLoop(self.engine)}
        self.srv = server_lib.create_server(self.holder, host='127.0.0.1',
                                            port=0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f'http://127.0.0.1:{self.srv.server_address[1]}'

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.holder['loop'].stop()
        self.thread.join(10)
        assert not self.thread.is_alive()


@pytest.fixture
def servers():
    made = []

    def make(**kw):
        made.append(_Server(**kw))
        return made[-1]

    yield make
    for s in made:
        s.close()


def _request(url, body=None, data=None, headers=None, method=None):
    if body is not None:
        data = json.dumps(body).encode()
    return urllib.request.Request(
        url, data=data, method=method,
        headers={'Content-Type': 'application/json', **(headers or {})})


def _call(url, **kw):
    """(status, headers, body bytes) of one request, errors included."""
    try:
        with urllib.request.urlopen(_request(url, **kw), timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _frames(resp):
    """SSE frames of an open response, one dict at a time."""
    for line in resp:
        line = line.strip()
        if line.startswith(b'data: '):
            yield json.loads(line[len(b'data: '):])


def _want(max_new):
    engine = inference.build_engine('tiny', **SERVER_KW)
    rid = engine.submit(list(_SERVER_PROMPT), _greedy(inference, max_new))
    return engine.run_to_completion()[rid]


def test_drain_migrates_a_stream_to_another_server(servers):
    """Server 1 drains mid-stream: the stream ends in a migrate frame;
    POST /internal/restore?sent=N on server 2 continues it with no
    duplicated or missing token. Afterwards server 1 refuses work (503)
    and a corrupted blob gets 400."""
    want = _want(32)
    one, two = servers(throttle=0.05), servers()
    resp = urllib.request.urlopen(_request(one.base + '/generate', body={
        'prompt_tokens': _SERVER_PROMPT, 'max_new_tokens': 32,
        'stream': True}), timeout=60)
    assert len(resp.headers['X-SkyTPU-Migration-Key']) == 32
    got, drained = [], {}
    for frame in _frames(resp):
        if 'token' in frame:
            got.append(frame['token'])
            if len(got) == 3 and not drained:
                threading.Thread(target=lambda: drained.update(
                    doc=_call(one.base + '/internal/drain?deadline=0',
                              body={}))).start()
        else:
            break
    resp.close()
    assert 'migrate' in frame, frame
    migrate = frame['migrate']
    assert migrate['sent'] == len(got) and len(got) < 32
    for _ in range(100):
        if drained:
            break
        time.sleep(0.05)
    status, _, body = drained['doc']
    assert status == 200 and json.loads(body) == {
        'status': 'drained', 'finished_naturally': False,
        'snapshots': [], 'migrated_streams': 1}
    status, _, body = _call(one.base + '/generate', body={
        'prompt_tokens': [1, 2], 'max_new_tokens': 2})
    assert status == 503 and json.loads(body) == {'error': 'replica draining'}
    blob = base64.b64decode(migrate['snapshot'])
    status, _, _ = _call(one.base + '/internal/restore', data=blob)
    assert status == 503
    status, _, body = _call(two.base + '/internal/restore?sent=1',
                            data=_flip(blob))
    assert status == 400 and 'SnapshotError' in json.loads(body)['error']
    resp = urllib.request.urlopen(_request(
        two.base + f"/internal/restore?sent={migrate['sent']}", data=blob),
        timeout=60)
    rest = []
    for frame in _frames(resp):
        if 'token' in frame:
            rest.append(frame['token'])
        else:
            break
    resp.close()
    assert frame == {'done': True, 'tokens': want}
    assert got + rest == want


def test_restore_without_room_is_409(servers):
    one, two = servers(throttle=0.05), servers(throttle=0.05)
    resp = urllib.request.urlopen(_request(one.base + '/generate', body={
        'prompt_tokens': _SERVER_PROMPT, 'max_new_tokens': 40,
        'stream': True}), timeout=60)
    key = resp.headers['X-SkyTPU-Migration-Key']
    next(_frames(resp))
    status, headers, blob = _call(one.base + f'/internal/snapshot?key={key}')
    assert status == 200 and int(headers['X-SkyTPU-Sent']) >= 1
    assert headers['Content-Type'] == 'application/octet-stream'
    assert {'error': 'request migrated away'} in list(_frames(resp))
    resp.close()
    assert _call(one.base + f'/internal/snapshot?key={key}')[0] == 404
    assert _call(one.base + '/internal/snapshot')[0] == 400
    # Fill both of server 2's slots, then restore: no free slot.
    threads = [threading.Thread(target=_call, args=(two.base + '/generate',),
                                kwargs=dict(body={'prompt_tokens': [i + 1],
                                                  'max_new_tokens': 40}))
               for i in range(2)]
    for t in threads:
        t.start()
    for _ in range(200):
        if two.holder['loop'].gauges['in_flight'] == 2:
            break
        time.sleep(0.02)
    status, _, body = _call(two.base + '/internal/restore?stream=0',
                            data=blob)
    assert status == 409 and 'RuntimeError' in json.loads(body)['error']
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    status, _, body = _call(two.base + '/internal/restore?stream=0',
                            data=blob)
    assert status == 200 and json.loads(body)['tokens'] == _want(40)


def test_handoff_frame_resume_and_abandon(servers):
    """X-SkyTPU-Handoff: 1 pauses the stream after its first token with a
    non-terminal handoff frame. /internal/resume resumes it ('resumed',
    then 'active'), and the stream finishes with every token; ?abandon=1
    drops another one. Unknown keys get 404."""
    want = _want(12)
    one = servers()
    headers = {'X-SkyTPU-Handoff': '1'}
    body = {'prompt_tokens': _SERVER_PROMPT, 'max_new_tokens': 12,
            'stream': True}
    resp = urllib.request.urlopen(_request(one.base + '/generate', body=body,
                                           headers=headers), timeout=60)
    key = resp.headers['X-SkyTPU-Migration-Key']
    frames = _frames(resp)
    assert next(frames) == {'token': want[0]}
    handoff = next(frames)['handoff']
    assert handoff['sent'] == 1
    header, _ = port_eng._snapshot_unpack(
        base64.b64decode(handoff['snapshot']))
    assert header['generated'] == want[:1] and header['layout'] == 'paged'
    status, _, text = _call(one.base + f'/internal/resume?key={key}',
                            method='POST', data=b'')
    assert (status, json.loads(text)) == (200, {'status': 'resumed'})
    status, _, text = _call(one.base + f'/internal/resume?key={key}')
    assert (status, json.loads(text)) == (200, {'status': 'active'})
    rest = [f for f in frames]
    resp.close()
    assert [f['token'] for f in rest[:-1]] == want[1:]
    assert rest[-1] == {'done': True, 'tokens': want}
    resp = urllib.request.urlopen(_request(one.base + '/generate', body=body,
                                           headers=headers), timeout=60)
    key = resp.headers['X-SkyTPU-Migration-Key']
    frames = _frames(resp)
    next(frames)
    assert 'handoff' in next(frames)
    status, _, text = _call(one.base + f'/internal/resume?key={key}'
                                       '&abandon=1', method='POST', data=b'')
    assert (status, json.loads(text)) == (200, {'status': 'abandoned'})
    assert next(frames) == {'error': 'request handed off to the decode pool'}
    resp.close()
    for query in (f'key={key}', f'key={key}&abandon=1'):
        assert _call(one.base + f'/internal/resume?{query}')[0] == 404
    assert _call(one.base + '/internal/resume')[0] == 400
    health = json.loads(_call(one.base + '/health')[2])['engine']
    assert set(health['kv_pages']) == {'total', 'free', 'cached', 'private'}
    assert set(health['prefix_cache']) == {'hits', 'misses',
                                           'reused_tokens', 'evictions'}


def test_prefix_cache_flag_defaults_to_the_knob(monkeypatch):
    assert server_lib.prefix_cache_arg('auto') is None
    assert server_lib.prefix_cache_arg('on') is True
    assert server_lib.prefix_cache_arg('off') is False
    monkeypatch.delenv('SKYTPU_PREFIX_CACHE', raising=False)
    engine = inference.build_engine('tiny', **SERVER_KW)
    assert engine._prefix is not None
    engine = inference.build_engine('tiny', prefix_cache=False, **SERVER_KW)
    assert engine._prefix is None
