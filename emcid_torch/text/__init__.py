from emcid_torch.text.tokenizer import CLIPBPETokenizer, make_tiny_tokenizer
from emcid_torch.text.token_range import decode_tokens, find_token_range
