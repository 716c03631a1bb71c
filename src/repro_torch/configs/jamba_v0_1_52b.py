"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Pattern period of 8 (attn_layer_offset=4, attn_layer_period=8 as in the HF
config); MoE MLP on every other layer (expert_layer_offset=1, period=2).
"""
from repro_torch.configs.base import ArchConfig, Block, MoEConfig, SSMConfig

_PERIOD = tuple(
    Block(
        kind=("attn" if i == 4 else "mamba"),
        mlp=("moe" if i % 2 == 1 else "gated_silu"),
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PERIOD,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk=256, conv_kernel=4, n_groups=1),
    tie_embeddings=False,
)
