"""Model definitions (HF/diffusers parameter names) and sampling."""
