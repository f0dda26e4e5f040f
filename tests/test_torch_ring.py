"""Ring attention against the reference's ring and against dense.

The reference side is skypilot_tpu's `ring_attention` under a mesh of
the tests' CPU devices with a `context` axis of 2 and of 4 (its
`shard_map` over the sequence), differentiated with `jax.vjp`; the port
side runs as gloo ranks on the CPU, spawned once per ring size for the
module, each holding its contiguous slice of the sequence:
- `ops.attention.ring_attention` (the plain form the CPU runs: an online
  softmax over sub-blocks, the K/V blocks passed on by
  `collectives.shift`), and
- `ops.flash_attention.ring_flash_attention` (`_RingFn`: the CUDA path's
  hops, merged (O, lse) and the backward on the merged lse with dK/dV
  travelling back around the ring, here through the kernels' plain
  versions because the tensors lie on the CPU).
Each rank's output slice and its dQ/dK/dV are held against the
reference's, and against dense attention over the whole sequence, within
1e-5 (f32). Then the dispatcher's refusals, as the reference's.
"""
import multiprocessing
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as ref_attn
from skypilot_tpu.parallel import MeshSpec, make_mesh
from skypilot_tpu_torch.ops import attention as port_attn

TOL = 1e-5
B, S, H, KV, D = 2, 32, 4, 2, 16
BLOCK = 8
RINGS = (2, 4)
CASES = [(impl, causal) for impl in ('plain', 'flash')
         for causal in (True, False)]


def _inputs():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _ref(ring, causal):
    """The reference's ring (and dense) output and (dq, dk, dv)."""
    q, k, v, do = (jnp.asarray(a) for a in _inputs())
    mesh = make_mesh(MeshSpec(fsdp=1, context=ring),
                     devices=jax.devices()[:ring])
    out = {}
    for name, fn in (
            ('ring', lambda q, k, v: ref_attn.ring_attention(
                q, k, v, mesh, causal=causal, block_size=BLOCK)),
            ('dense', lambda q, k, v: ref_attn.dense_attention(
                q, k, v, causal=causal))):
        def fwd_bwd(q, k, v, do, fn=fn):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o,) + vjp(do)
        out[name] = [np.asarray(a) for a in jax.jit(fwd_bwd)(q, k, v, do)]
    return out


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _rank(rank, ring, port, out):
    os.environ.update(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{port}',
                      SKYTPU_NUM_PROCESSES=str(ring),
                      SKYTPU_PROCESS_ID=str(rank))
    os.environ.pop('SKYTPU_TORCH_DIST_BACKEND', None)
    torch.set_num_threads(1)
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.mesh_from_env(mesh_lib.MeshSpec(fsdp=1, context=ring),
                                  'cpu')
    part = slice(rank * S // ring, (rank + 1) * S // ring)
    got = {}
    for impl, causal in CASES:
        q, k, v, do = (torch.from_numpy(np.ascontiguousarray(a[:, part]))
                       for a in _inputs())
        for t in (q, k, v):
            t.requires_grad_(True)
        if impl == 'plain':
            o = port_attn.ring_attention(q, k, v, mesh, causal=causal,
                                         block_size=BLOCK)
        else:
            o = fa.ring_flash_attention(q, k, v, mesh.group('context'),
                                        causal=causal, block_q=BLOCK,
                                        block_k=BLOCK)
        grads = torch.autograd.grad(o, (q, k, v), do)
        got[(impl, causal)] = [o.detach().numpy()] + [
            g.numpy() for g in grads]
    out.put((rank, got))
    # Flush the result, then leave without the interpreter's teardown: a
    # rank whose process groups are torn down after rank 0 (the store's
    # host) has gone can hang or abort (ROADMAP Queue 3).
    out.close()
    out.join_thread()
    os._exit(0)


@pytest.fixture(scope='module')
def rings():
    """Each ring size's ranks, their slices put back in rank order."""
    ctx = multiprocessing.get_context('spawn')
    runs = {}
    for ring in RINGS:
        out = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, ring, port, out))
                 for r in range(ring)]
        for p in procs:
            p.start()
        runs[ring] = (procs, out)
    refs = {(ring, causal): _ref(ring, causal) for ring in RINGS
            for causal in (True, False)}
    got = {}
    for ring, (procs, out) in runs.items():
        try:
            parts = dict(out.get(timeout=300) for _ in procs)
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
        assert [p.exitcode for p in procs] == [0] * ring
        for case in CASES:
            got[(ring,) + case] = [
                np.concatenate([parts[r][case][i] for r in range(ring)], 1)
                for i in range(4)]
    return got, refs


@pytest.mark.parametrize('ring', RINGS)
@pytest.mark.parametrize('impl,causal', CASES,
                         ids=[f'{i}-{"causal" if c else "full"}'
                              for i, c in CASES])
def test_ring_matches_reference_ring_and_dense(rings, ring, impl, causal):
    got, refs = rings
    mine = got[(ring, impl, causal)]
    for against in ('ring', 'dense'):
        for what, a, b in zip(('out', 'dq', 'dk', 'dv'), mine,
                              refs[(ring, causal)][against]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f'{what} vs {against}')


def test_ring_refuses_what_the_reference_refuses():
    """No mesh, a window or a softcap raise, as the reference's
    :304-310; a mesh with one rank on `context` is blockwise (:193)."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match='requires a mesh'):
        port_attn.attention(q, k, v, impl='ring')
    one = mesh_lib.Mesh(mesh_lib.MeshSpec().resolve(1), 0, 1,
                        torch.device('cpu'))
    for kw in ({'window': 8}, {'softcap': 30.0}):
        with pytest.raises(ValueError, match='window/softcap'):
            port_attn.attention(q, k, v, impl='ring', mesh=one, **kw)
    assert torch.equal(
        port_attn.attention(q, k, v, impl='ring', mesh=one, block_size=8),
        port_attn.blockwise_attention(q, k, v, block_size=8))
