"""Model definitions (HF/diffusers parameter names) and sampling."""
from emcid_torch.models.configs import (
    CLIPTextConfig,
    UNetConfig,
    VAEConfig,
    SD_V14_TEXT,
    SDXL_TEXT_1,
    SDXL_TEXT_2,
    TINY_TEXT,
    sd_v14_unet,
    sdxl_unet,
    tiny_unet,
    sd_vae,
    sdxl_vae,
    tiny_vae,
)
from emcid_torch.models.clip_text import CLIPTextEncoder, TextOutput
from emcid_torch.models.sdxl import (
    SDXLComponents,
    build_random_sdxl_pipeline,
    build_tiny_sdxl_pipeline,
    encode_prompts_sdxl,
    from_jax_sdxl,
    generate_sdxl,
    load_sdxl_pipeline,
    sample_latents_sdxl,
)
