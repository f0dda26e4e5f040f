"""chip_smoke's serve_ctl phase rehearsed on the CPU at the tiny size.

The phase's replicas are tiny port servers on the CPU (`--model tiny
--device cpu`), launched as processes by the port's controller, which
serve/core.up spawns; the in-process answers come from a tiny engine of
the same seed and arguments. In both, a stand-in counts K1's launches
(`count_plain_launches`: it computes the plain version, as
`tests/test_torch_lb_phase.py` counts them), so each replica's
/internal/kernels reports its own; the sizes are cut to the tiny model
and the controller's loop to 0.1 s. Legs (a)-(e) run their gates, the
sound run breaks none, and every fault `serve_fault_check.py` plants
breaks the gate it names (`serve_fault_check.check`, the card's own
loop). The card's memory and nvidia-smi readings are the card's alone:
on the CPU the phase reads neither.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import serve_fault_check  # noqa: E402

TINY_KW = dict(batch_size=2, max_seq_len=160, prefill_chunk=16,
               kv_page_size=8)
# A replica: the port's server with K1's launches counted.
REPLICA = '''\
import sys
sys.path.insert(0, {tests!r})
import test_torch_serve_phase
test_torch_serve_phase.count_plain_launches(setattr)
from skypilot_tpu_torch.inference import server
server.main()
'''


def count_plain_launches(patch):
    """Every engine's prefill through the flash path, each K1 call
    tallied as the card's wrapper tallies a launch and computed by the
    plain version; `patch(obj, name, value)` sets each stand-in."""
    from skypilot_tpu_torch.inference import engine as eng
    from skypilot_tpu_torch.ops import flash_attention as fa

    def launch(q, k, v, causal, window, softcap, q_offset, k_scale=None,
               v_scale=None):
        fa._count(fa.flash_attention, window, causal, q_offset)
        return fa._plain(q, k, v, causal, 512, window, softcap, q_offset,
                         k_scale=k_scale, v_scale=v_scale)

    def flash_fwd(q, k, v, causal=True, block_q=512, block_k=512,
                  window=None, softcap=None, q_offset=None, k_scale=None,
                  v_scale=None):
        return fa._launch(q, k, v, causal, window, softcap, q_offset,
                          k_scale=k_scale, v_scale=v_scale)

    patch(fa, '_launch', launch)
    patch(fa, 'flash_fwd', flash_fwd)
    patch(eng, 'default_use_flash', lambda device: True)


@pytest.fixture
def tiny_service(monkeypatch, tmp_path):
    """The phase's sizes cut to `tiny` on the CPU, its replicas and its
    in-process answers counting K1's launches."""
    from skypilot_tpu_torch import inference
    from skypilot_tpu_torch.ops import flash_attention as fa
    replica = tmp_path / 'replica.py'
    replica.write_text(REPLICA.format(tests=os.path.dirname(
        os.path.abspath(__file__))))
    for name, value in (('DEV', 'cpu'), ('CTL_MODEL', 'tiny'),
                        ('CTL_KW', TINY_KW), ('CTL_PROMPT_LENGTHS', (20, 60)),
                        ('CTL_TTFT_PROMPT', 30), ('CTL_NEW', 6),
                        ('CTL_CLIENT_NEW', 4), ('CTL_BOOT_WAIT_S', 120),
                        ('CTL_REACT_S', 5), ('CTL_SERVER', (str(replica),)),
                        ('CTL_ENV', {**chip_smoke.CTL_ENV,
                                     'SKYTPU_SERVE_LOOP_INTERVAL': '0.1'})):
        monkeypatch.setattr(chip_smoke, name, value)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    engine = inference.build_engine('tiny', device='cpu', seed=0, **TINY_KW)
    with monkeypatch.context() as m:
        count_plain_launches(m.setattr)
        flash = inference.InferenceEngine(engine.params, engine.config,
                                          device='cpu', use_flash=True,
                                          **TINY_KW)
        ref = chip_smoke.ctl_reference(torch, inference, fa, flash,
                                       np.random.default_rng(18))
    # The dense path, without the stand-in, answers alike.
    plain = [chip_smoke.greedy_tokens(inference, engine, p,
                                      chip_smoke.CTL_NEW)[0]
             for p in ref['prompts'] + [ref['ttft_prompt']]]
    assert plain == ref['want'] + [ref['ttft_want']]
    # Each run's state under this test's directory, where the suite's
    # leaked-process guard looks.
    yield lambda fault: serve_fault_check.run_in_state_dir(
        torch, ref, fault, root=str(tmp_path))
    torch.set_num_threads(threads)


def test_serve_ctl_phase_and_its_faults_rehearse_on_cpu(tiny_service):
    lines, failed = serve_fault_check.check(tiny_service,
                                            list(chip_smoke.CTL_FAULTS))
    sound = lines[0]
    assert sound['fault'] is None and not sound['broken'], sound['details']
    assert not failed, [(ln['fault'], ln['details']) for ln in lines
                        if not ln['ok']]
    out = sound['readings']
    assert out['kernel_launches'] == out['expected_launches'] > 0
    assert out['reference_launches'] == out['replica_launches']['up']
    assert set(out['replica_launches']) == {'up', 'heal', 'update'}
    assert out['heal']['new_ids'] and out['update']['bad'] == 0
    assert out['update']['replicas'] == [(3, 2)]
    assert out['update']['requests'] > 1
    for key in ('launch_to_ready_s', 'first_token_s', 'kill_to_ready_s',
                'update_s'):
        assert out[key] > 0, key
    assert out['controller']['maps_cuda'] is False
    assert set(out['leg_s']) == {'up', 'heal', 'update', 'down'}
