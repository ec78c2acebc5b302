"""The MoE layer's three paths on the card (``chip_smoke.py`` phase 20a at
a reduced width): the local path, and the sharded and weights-stationary
paths on the 1 x 1 NCCL smoke mesh.  Imports no JAX, so it runs on the
GPU machine: ``python3 -m pytest -q -m cuda tests/test_torch_moe_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import MoEConfig, get_config
from repro_torch.models import moe


@pytest.mark.cuda
@pytest.mark.parametrize("T,groups", [(4, 1), (4, 4), (128, 1)])
def test_cuda_moe_paths_agree_on_the_smoke_mesh(T, groups):
    """bf16, mixtral's routing (E 8, K 2, capacity factor 1.25) at d 512,
    f 1024: the mesh paths within 2e-2 of max |out| from the local path,
    each through its collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_smoke_mesh
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        get_config("mixtral-8x22b"), d_model=512, d_ff=1024, head_dim=64,
        num_heads=8, moe=MoEConfig(num_experts=8, top_k=2,
                                   capacity_factor=1.25))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.bfloat16, dev)
    x = torch.randn((groups, T // groups, 512), generator=gen,
                    device=dev).to(torch.bfloat16)
    want, _ = moe.apply_moe(p, cfg, x, groups)
    mesh = make_smoke_mesh(dev)
    mine = sharding.place_params(mesh, {"layers": [{"ffn": p}]},
                                 cfg)["layers"][0]["ffn"]
    scale = want.float().abs().max().item()
    for stationary in (False, True):
        c = dataclasses.replace(cfg, moe_stationary_serve=stationary)
        moe.reset_collectives()
        with sharding.use(sharding.ShardingContext(mesh)):
            got, _ = moe.apply_moe(mine, c, x, groups)
        torch.cuda.synchronize()
        assert moe.collectives["all_reduce"] > 0
        assert moe.collectives["all_gather"] == 1
        err = (got.float() - want.float()).abs().max().item() / scale
        assert err < 2e-2, (stationary, err)
