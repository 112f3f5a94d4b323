"""SeamlessM4T-Large-v2 — encoder-decoder multimodal backbone (audio stub).

[arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large]  24L(enc)+24L(dec)
d_model=1024 16H (MHA: kv=16) d_ff=8192 vocab=256206.  The speech frontend
(w2v-BERT feature extractor) is a STUB: ``input_specs`` provides precomputed
frame embeddings.  Decode shapes exercise the text decoder with cross
attention to the encoder memory.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,  # decoder
        encoder_layers=24,
        enc_dec=True,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        attention="gqa",  # kv=heads => plain MHA
        rope_theta=1e4,
        frontend="audio",
        frontend_positions=1024,  # precomputed speech frames per utterance
        remat="full",
        notes="Enc-dec; audio frontend stubbed (frame embeddings provided).",
    )
)
