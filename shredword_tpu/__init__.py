"""shredword_tpu — BPE/Unigram tokenizer trainer framework on JAX.

Capabilities of shivendrra/shredword, redesigned for an accelerator:
  - ``BPETrainer`` — reference-parity training API (trainer.py:5-39) with
    the merge loop running on device inside ``lax.while_loop``
  - ``Tokenizer`` — the encode/decode/save/load the reference stubs out
    (base.py:107-109), CPU-native and device batch backends
  - ``shredword_tpu.parallel`` — data-parallel sharded training over a
    ``jax.sharding.Mesh`` (greenfield; the reference is single-threaded)
  - both reference model formats (binary triples + "shredword v1" text)
"""

from .config import BPEConfig, UnigramConfig
from .errors import (ConfigError, CorpusError, DecodeError, EncodeError,
                     SerializationError, ShredError, TrainingError)
from .models.bpe import BPETrainer
from .models.unigram import UnigramTokenizer, UnigramTrainer
from .tokenizer import (Tokenizer, build_vocab, get_stats, merge,
                        render_token)

__version__ = "0.1.0"

__all__ = [
    "BPETrainer", "Tokenizer", "BPEConfig", "render_token",
    "get_stats", "merge", "build_vocab",
    "UnigramTrainer", "UnigramTokenizer", "UnigramConfig",
    "ShredError", "CorpusError", "ConfigError", "TrainingError",
    "SerializationError", "EncodeError", "DecodeError",
    "__version__",
]
