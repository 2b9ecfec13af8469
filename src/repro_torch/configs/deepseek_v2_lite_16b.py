"""deepseek-v2-lite-16b — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite, config.json].
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; layer 0 dense
(d_ff=10944); no q LoRA.

Pure full attention over the (compressed) cache. The port serves it at
full width on one card: 15,706,484,224 parameters, 31.4 GB in bf16.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=10944,              # dense first layer
    vocab=102400,
    attn_kind="mla",
    q_lora_rank=0,
    kv_lora_rank=512,
    mla_d_nope=128,
    mla_d_rope=64,
    mla_d_v=128,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    first_dense=1,
    routed_scale=1.0,
    rope_theta=10000.0,
)
