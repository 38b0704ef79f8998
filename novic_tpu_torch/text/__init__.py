from novic_tpu_torch.text.tokenizer import TextTokenizer  # noqa: F401
from novic_tpu_torch.text.target import TargetConfig, TargetTokenizer  # noqa: F401
