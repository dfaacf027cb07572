"""Two CLI hosts of the port against one process, on the CPU: the port's
counterpart of tests/test_multihost.py.

Each host is its own ``python -m nerf_fl_torch.train --num_hosts 2
--host_index i --num_gpus 2`` process (NERF_FL_TORCH_DEVICE=cpu, one
thread), which starts its one rank; the ranks meet at the coordinator's
address over gloo.  The job trains the tiny Blender fixture end to end
(host-fed batches, each host keeping its rows of the same permutation, in
K-steps of 3 sub-steps around the all-reduce, validation rendered through
the mesh) and must reproduce the one-process run (``--num_gpus 1``, the
device pool; the same batches and the same draws by construction): the
weights within 5e-4 and the same global step, the limits of
tests/test_multihost.py.  Only host 0 writes a checkpoint.  Then the
resume-divergence guard: host 0 resumes from the one-process checkpoint,
host 1 starts fresh, and both processes fail with its message.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from nerf_fl_torch import opt as topt
from nerf_fl_torch import train as ttrain
from nerf_fl_torch.parallel.launch import free_port
from nerf_fl_torch.training import checkpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _argv(scene, save, exp):
    return ["--root_dir", scene, "--dataset_name", "blender",
            "--img_wh", "40", "40", "--N_samples", "8", "--N_importance",
            "8", "--mlp_width", "32", "--batch_size", "256", "--chunk",
            "4096", "--noise_std", "0", "--num_epochs", "1",
            "--lr_scheduler", "cosine", "--steps_per_execution", "3",
            "--refresh_every", "0", "--exp_name", exp, "--save_path", save]


def _hosts(scene, tmp_path, tag, extra=None):
    """Start both hosts of a job; their (return code, output)."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "NERF_FL_TORCH_DEVICE": "cpu",
           "OMP_NUM_THREADS": "1"}
    procs = []
    for i in range(2):
        cwd = tmp_path / f"{tag}{i}"
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nerf_fl_torch.train"]
            + _argv(scene, str(cwd / "ckpts"), "mh")
            + ["--num_gpus", "2", "--num_hosts", "2", "--host_index", str(i),
               "--coordinator_address", f"localhost:{port}"]
            + ((extra or {}).get(i, [])),
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_cli_hosts_match_one_process(blender_scene, tmp_path,
                                         monkeypatch):
    res = _hosts(blender_scene, tmp_path, "host")
    for i, (rc, out) in enumerate(res):
        assert rc == 0, f"host {i} failed:\n{out[-3000:]}"
        assert "val/psnr=" in out
        assert "device-resident ray pool" not in out     # host-fed
    mh_path = tmp_path / "host0" / "ckpts" / "mh" / "epoch=0.ckpt"
    assert mh_path.exists()
    assert not (tmp_path / "host1" / "ckpts").exists()   # host 0 writes
    mh = checkpoints.load_checkpoint(str(mh_path))

    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    one = ttrain.main(topt.get_opts(_argv(blender_scene, "sp", "sp")),
                      device="cpu")
    assert mh["global_step"] == one.global_step \
        == one.batcher.steps_per_epoch()
    for key, name in (("nerf_coarse", "xyz.0.weight"),
                      ("nerf_fine", "dir.weight")):
        want = dict(one.params[key].named_parameters())[name]
        np.testing.assert_allclose(mh["state_dict"][key][name].numpy(),
                                   want.detach().numpy(), atol=5e-4,
                                   err_msg=f"{key}.{name}")

    # the resume-divergence guard: host 0 resumes from the one-process
    # checkpoint, host 1 starts fresh -> both fail instead of mixing states
    sp_ckpt = str(tmp_path / "sp" / "sp" / "epoch=0.ckpt")
    res = _hosts(blender_scene, tmp_path, "div",
                 {0: ["--ckpt_path", sp_ckpt]})
    assert all(rc != 0 for rc, _ in res), [out[-2000:] for _, out in res]
    assert all("checkpoint resume state differs across hosts" in out
               for _, out in res), [out[-2000:] for _, out in res]
