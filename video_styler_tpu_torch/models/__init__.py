"""The port's models: Wan DiT, VACE branch, umT5 encoder, Wan2.1 VAE; the
FLUX DiT, the SD3/FLUX image VAE, CLIP-L and T5 v1.1."""
from .flux_dit import (FLUX_DEV, FLUX_DIT_TINY, FLUX_SCHNELL, FluxDiT,  # noqa: F401
                       FluxDiTConfig, flux_dit_forward)
from .sd3_text_encoder import (CLIP_L, ClipTextConfig, ClipTextEncoder,  # noqa: F401
                               sd3_text_encoder_1_forward)
from .sd3_vae import (FLUX_VAE, SD3_VAE, SD3VAEConfig, SD3VAEDecoder,  # noqa: F401
                      SD3VAEEncoder, sd3_vae_decoder_forward, sd3_vae_encoder_forward)
from .t5 import T5_V11_TINY, T5_V11_XXL  # noqa: F401
