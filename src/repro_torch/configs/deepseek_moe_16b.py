"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16 = MHA)
expert d_ff=1408 vocab=102400; 2 shared + 64 routed top-6 (fine-grained)
[arXiv:2401.06066; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", kind="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab=102400,
        n_experts=64, n_shared_experts=2, top_k=6, d_expert=1408,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", kind="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
        n_experts=8, n_shared_experts=2, top_k=2, d_expert=32,
    )
