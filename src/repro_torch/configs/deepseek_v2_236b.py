"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2, config.json].
60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; layer 0 is dense
(d_ff=12288); q_lora_rank=1536.

Pure full attention over the (compressed) cache. 235.7 B parameters (471
GB in bf16) fit neither one card nor four: the port runs it reduced only.
Its expert-parallel path exists (`repro_torch.models.moe` over an
`LMMesh`); a host with the cards to hold it does not (ROADMAP item 18).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    d_ff=12288,              # dense first layer
    vocab=102400,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    mla_d_nope=128,
    mla_d_rope=64,
    mla_d_v=128,
    moe=True,
    n_experts=160,
    top_k=6,
    d_ff_expert=1536,
    n_shared_experts=2,
    first_dense=1,
    routed_scale=16.0,
    rope_theta=10000.0,
)
