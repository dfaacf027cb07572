"""Training entry point of the port, the counterpart of the root train.py:

    python -m nerf_fl_torch.train --dataset_name blender --root_dir <lego> \
        --N_importance 64 --img_wh 400 400 --noise_std 0 --num_epochs 20 \
        --batch_size 1024 --optimizer adam --lr 5e-4 --lr_scheduler cosine \
        --exp_name exp

mip-NeRF at its Blender recipe (google/mipnerf configs/blender.gin):

    python -m nerf_fl_torch.train --dataset_name blender --root_dir <lego> \
        --model mipnerf --img_wh 800 800 --N_samples 128 --noise_std 0 \
        --batch_size 4096 --optimizer adam --lr 5e-4 --lr_scheduler mip \
        --device_pool on --steps_per_execution 10 --exp_name mip

It runs on the card; ``NERF_FL_TORCH_DEVICE=cpu`` (or ``main(hparams,
device="cpu")``) asks for the CPU, and without either and without a card
it raises.  After fit it prints the host spans of the run
(``utils/spans.py``): ``[spans] nerf.fit.checkpoint N x S s; ...``, each
span's count and host seconds.  On the card its last line counts the fused
kernels of the run: ``[kernels] N sub-steps; fused forward / backward: L /
L host launches, R / R runs on the card; sigma-only forward: L host
launches, R runs on the card; IPE forward / backward (mip-NeRF's, among
the fused): R / R runs on the card`` (the wrappers' launches and the
kernels' own count of their runs, CUDA graph replays included; the
sigma-only kernel runs eval's f32 test-time coarse pass, so it reads 0
here: the train step and validation render the full coarse pass; the IPE
kernels run both levels of ``--model mipnerf`` at f32, 2 + 2 a sub-step),
and, after a fused launch, the blocks of the run's compute dtype:
``; float32 blocks: forward T threads (C consumer warpgroups), backward T
(C)``.

``--num_gpus D --model_parallel M`` (D x M > 1) trains data- and
tensor-parallel: this process starts its ``D x M / --num_hosts`` ranks
(``parallel.launch``: one process a card, or all on the CPU over gloo)
and waits for them; each rank runs ``NeRFSystem`` on its mesh and prints
its own ``[kernels]`` line.  A multi-host job runs this CLI on every host
with ``--num_hosts``, ``--host_index`` and ``--coordinator_address``
(host:port of host 0), as the JAX CLI does.  Too few cards raise
``parallel.make_mesh``'s error before any rank starts.
"""
from .device import entry_device
from .opt import get_opts
from .training.system import NeRFSystem
from .utils import spans


def train(device, hparams) -> NeRFSystem:
    """Set up, configure and fit one process's ``NeRFSystem`` (one rank of
    a job, or the whole run without one)."""
    system = NeRFSystem(hparams, device=device)
    system.setup()
    system.configure()
    system.fit()
    print(f"[spans] {spans.STORE.summary()}", flush=True)
    if system.device.type == "cuda":
        import torch
        from .ops import fused_mlp as fm
        runs = fm.kernel_runs(system.device)
        blocks = ""
        if fm.fused_mlp_fwd_cuda.launches:
            dtype = system.cfg.compute_dtype
            b = fm.kernel_block_info(getattr(torch, dtype))
            blocks = (f"; {dtype} blocks: forward {b['threads']} threads "
                      f"({b['consumers']} consumer warpgroups), backward "
                      f"{b['bwd_threads']} ({b['bwd_consumers']})")
        print(f"[kernels] {system.global_step} sub-steps; fused forward / "
              f"backward: {fm.fused_mlp_fwd_cuda.launches} / "
              f"{fm.fused_mlp_bwd_cuda.launches} host launches, {runs[0]} / "
              f"{runs[1]} runs on the card; sigma-only forward: "
              f"{fm.fused_sigma_cuda.launches} host launches, "
              f"{fm.sigma_runs(system.device)} runs on the card; IPE "
              f"forward / backward (mip-NeRF's, among the fused): "
              f"{'{} / {}'.format(*fm.ipe_runs(system.device))} runs on "
              f"the card{blocks}", flush=True)
    return system


def _rank(device, hparams) -> None:
    train(device, hparams)


def main(hparams, device=None):
    """Train; returns the ``NeRFSystem``, or None for a job of several
    ranks (which live in their own processes)."""
    from .parallel import launch
    dev = entry_device(device)
    def g(name, default):
        return getattr(hparams, name, default)

    num_data, num_model = max(1, g("num_gpus", 1)), \
        max(1, g("model_parallel", 1))
    num_hosts = max(1, g("num_hosts", 1))
    if num_data * num_model == 1 and num_hosts == 1:
        return train(dev, hparams)
    launch.spawn_cli(_rank, hparams, dev, num_data, num_model,
                     num_hosts=num_hosts, host_index=g("host_index", 0),
                     coordinator=g("coordinator_address", None))
    return None


if __name__ == "__main__":
    main(get_opts())
