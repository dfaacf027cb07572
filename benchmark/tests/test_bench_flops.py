"""The operation counts behind the rooflines and `mfu`, against
`chip_smoke.py:fine_macs` (which they were copied from) and against the
layer shapes of the reference's weights."""
import math

import pytest

import chip_smoke
from benchmark import flops, spec
from benchmark.reference import nerfw
from nerf_fl_torch.render import RenderConfig

CONFIGS = ["nerfw_lego", "barf_brandenburg"]


def load(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def render_config(c):
    m = c["model"]
    return RenderConfig(N_emb_xyz=m["N_emb_xyz"], N_emb_dir=m["N_emb_dir"],
                        encode_a=m["encode_a"], N_a=m["N_a"],
                        encode_t=m["encode_t"], N_tau=m["N_tau"],
                        mlp_depth=m["D"], mlp_width=m["W"])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("a,t", [(None, None), (0, False), (48, True)])
def test_fine_macs_is_chip_smokes(name, a, t):
    c = load(name)
    assert flops.fine_macs(flops.shape(c), a, t) == \
        chip_smoke.fine_macs(render_config(c), a, t)


@pytest.mark.parametrize("name", CONFIGS)
def test_macs_are_the_weights_of_the_layers(name):
    c = load(name)
    for typ, macs in (("coarse", flops.fine_macs(flops.shape(c), 0, False)),
                      ("fine", flops.fine_macs(flops.shape(c)))):
        assert macs == sum(fo * fi for _, fo, fi
                           in nerfw.layer_spec(c["model"], typ))
    sig = [(n, fo, fi) for n, fo, fi in nerfw.layer_spec(c["model"], "coarse")
           if n.startswith("xyz.") or n == "static_sigma"]
    assert flops.sigma_macs(flops.shape(c)) == sum(fo * fi
                                                   for _, fo, fi in sig)


def test_train_and_frame_flops():
    c = load("nerfw_lego")
    # 771 GFLOP a sub-step; 38.1 TFLOP a 400 x 400 frame
    assert math.isclose(flops.train_flops(c), 7.713e11, rel_tol=1e-3)
    assert math.isclose(flops.frame_flops(c, 160000), 3.808e13, rel_tol=1e-3)


def test_backward_is_twice_the_forward():
    c = load("nerfw_lego")
    for launch in flops.train_launches(c):
        f, _ = flops.fused_fwd(c, *launch)
        b, _ = flops.fused_bwd(c, *launch)
        assert b == 2 * f
    assert flops.least_seconds(495e12, 1.0, 495e12, 3.35e12) == 1.0
