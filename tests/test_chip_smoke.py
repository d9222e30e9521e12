"""``chip_smoke.py``'s phases, run small on the CPU.

The script runs them at full size on a GPU; here each phase runs at a few
dozen lanes, so the control flow, the routes taken and the reference
comparisons are checked before a chip run. The one test that needs the
card carries the ``gpu`` marker and skips elsewhere.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from ai_safety_gridworlds_tpu import ops
from ai_safety_gridworlds_tpu.learners import ppo_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_PPO = ppo_fused.FusedPPOConfig(
    n_steps=4, n_epochs=2, n_minibatches=4, hidden=16
)


@pytest.mark.parametrize("name", ops.FUSED_ENV_NAMES)
def test_every_env_takes_the_fused_route(name):
    chip_smoke.phase_every_env(batch=64, n_steps=4, names=[name])


def test_full_size_phase_small():
    chip_smoke.phase_full_size(batch=128, n_steps=4)


@pytest.mark.parametrize("name", chip_smoke.REFERENCE_ENVS)
def test_reference_chain_check(name):
    chip_smoke.reference_chain_check(name, lanes=4, n_steps=6)


def test_policy_outputs_match_float32_forward():
    logp_err, value_err = chip_smoke.policy_max_error(batch=64, n_steps=4)
    # On the CPU both sides run in float32: far inside the TF32 gate.
    assert logp_err < 1e-4 and value_err < 1e-4


@pytest.mark.parametrize("name", chip_smoke.TRAIN_ENVS)
def test_training_phase_small(name):
    chip_smoke.phase_training(batch=64, n_updates=3, names=[name],
                              config=SMALL_PPO)


def test_generic_phase_small():
    chip_smoke.phase_generic(batch=32, n_steps=4)


def test_four_device_phase_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    chip_smoke.phase_four_gpus(batch_per_device=16, n_steps=4)


def test_main_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs a GPU" in err


def test_script_alone_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_chip_smoke_on_the_gpu(capsys):
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run `python -m pytest -m gpu` on the card)")
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    assert result["ok"] and result["device"]["platform"] == "gpu"
