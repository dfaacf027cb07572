"""Training entry point of the port, the counterpart of the root train.py:

    python -m nerf_fl_torch.train --dataset_name blender --root_dir <lego> \
        --N_importance 64 --img_wh 400 400 --noise_std 0 --num_epochs 20 \
        --batch_size 1024 --optimizer adam --lr 5e-4 --lr_scheduler cosine \
        --exp_name exp

It runs on the card; ``NERF_FL_TORCH_DEVICE=cpu`` (or ``main(hparams,
device="cpu")``) asks for the CPU, and without either and without a card
it raises.  On the card its last line counts the fused kernels of the
run: ``[kernels] N sub-steps; fused forward / backward: L / L host
launches, R / R runs on the card`` (the wrappers' launches and the
kernels' own count of their runs, CUDA graph replays included).
"""
from .device import entry_device
from .opt import get_opts
from .training.system import NeRFSystem


def main(hparams, device=None) -> NeRFSystem:
    system = NeRFSystem(hparams, device=entry_device(device))
    system.setup()
    system.configure()
    system.fit()
    if system.device.type == "cuda":
        from .ops import fused_mlp as fm
        runs = fm.kernel_runs(system.device)
        print(f"[kernels] {system.global_step} sub-steps; fused forward / "
              f"backward: {fm.fused_mlp_fwd_cuda.launches} / "
              f"{fm.fused_mlp_bwd_cuda.launches} host launches, {runs[0]} / "
              f"{runs[1]} runs on the card", flush=True)
    return system


if __name__ == "__main__":
    main(get_opts())
