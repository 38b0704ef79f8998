"""Embedder: the frozen dual-encoder abstraction (the counterpart of
novic_tpu.embedders.base).

'TYPE:NAME' factory, tokenizer metadata, lazy model load/unload, target-config
creation and management, configuration hashing for cache compatibility (the
same configuration dicts, hence the same hashes, as the JAX package's
embedders), unit-norm float32 text and image embeddings. The towers are
PyTorch modules on an explicit device (CUDA by default). Embeddings come back
as numpy float32 unit vectors, as in the JAX package. The tokenizer is chosen
as the JAX package chooses it: the CLIP BPE, SentencePiece or WordPiece
tokenizer when `bpe_merges_path` or $NOVIC_CLIP_BPE / $NOVIC_SIGLIP_SPM /
$NOVIC_BERT_VOCAB names a file, else the word-level test tokenizer.

Also provides the 'test:<dim>' embedder, whose BLAKE2-derived vectors are
byte-identical to the JAX package's, and builds the structured modality-gap
test embedder 'test-structured:<dim>[:...]' (embedders/structured.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.preprocess import (
    PreprocessConfig,
    is_final_size_batch,
    preprocess_frames,
    preprocess_pil_host,
)
from novic_tpu_torch.embedders.registry import EmbedderArch, lookup
from novic_tpu_torch.parallel.mesh import gather_rows, same_device, shard_rows
from novic_tpu_torch.parallel.tp import TPGroup, shard_tower, validate_tp_divisibility
from novic_tpu_torch.text.simple import SimpleWordTokenizer
from novic_tpu_torch.text.target import TargetConfig, TargetTokenizer, create_target_config
from novic_tpu_torch.text.tokenizer import TextTokenizer
from novic_tpu_torch.utils import trace
from novic_tpu_torch.utils.logger import log


class Embedder:
    """Frozen dual-encoder wrapper; see module docstring."""

    @staticmethod
    def create(
        spec: str,                          # 'TYPE:NAME' (openai:/openclip:/transformers:/test:/test-structured:)
        *,
        tokenizer_batch_size: int = 1024,
        inference_batch_size: int = 256,
        image_batch_size: int = 128,
        load_model: bool = True,
        check: bool = False,
        weights_path: Optional[str] = None,    # converted .npz tower weights
        bpe_merges_path: Optional[str] = None, # CLIP BPE merges file (or $NOVIC_CLIP_BPE)
        tokenizer: Optional[TextTokenizer] = None,  # explicit override (tests/benches)
        compute_dtype: str = "bfloat16",
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        lexicon: Optional[dict] = None,     # test-structured: variant -> noun matching table
    ) -> "Embedder":
        if ":" not in spec:
            raise ValueError(f"Embedder spec must be of the format 'TYPE:NAME': {spec}")
        kind, name = spec.split(":", maxsplit=1)
        sizes = dict(tokenizer_batch_size=tokenizer_batch_size,
                     inference_batch_size=inference_batch_size, image_batch_size=image_batch_size)
        if kind == "test":
            return HashEmbedder(spec=spec, embed_dim=int(name), check=check, tokenizer=tokenizer,
                                **sizes)
        if kind == "test-structured":
            from novic_tpu_torch.embedders.structured import (
                StructuredEmbedder,
                parse_structured_spec,
            )

            return StructuredEmbedder(spec=spec, lexicon=lexicon, check=check,
                                      tokenizer=tokenizer, **sizes,
                                      **parse_structured_spec(spec, name))
        if kind not in ("openai", "openclip", "transformers"):
            raise ValueError(f"Unsupported embedder type: {kind}")
        return TorchEmbedder(spec=spec, arch=lookup(spec), load_model=load_model, check=check,
                             weights_path=weights_path, bpe_merges_path=bpe_merges_path,
                             tokenizer=tokenizer, compute_dtype=compute_dtype, seed=seed,
                             device=device, **sizes)

    def __init__(self, *, spec: str, configuration: dict[str, Any], tokenizer: TextTokenizer,
                 embed_dim: int, check: bool, config_class: str, tokenizer_batch_size: int = 1024,
                 inference_batch_size: int = 256, image_batch_size: int = 128):
        self.spec = spec
        self.tokenizer = tokenizer
        self.embed_dim = embed_dim
        self.embed_dtype = np.dtype(np.float32)
        self.tokenizer_batch_size = tokenizer_batch_size
        self.inference_batch_size = inference_batch_size
        self.image_batch_size = image_batch_size
        self.check = check
        # `config_class` is the class name the JAX package records for this kind
        # of embedder: caches check the hash of this dict, so both packages write it alike
        self.configuration = dict(configuration)
        self.configuration["class"] = config_class
        self.target_tokenizer: Optional[TargetTokenizer] = None
        self.target_vocab: Optional[tuple[str, ...]] = None
        log.info(f"Created embedder {spec}: dim {embed_dim}, "
                 f"context {tokenizer.context_length}, vocab {tokenizer.vocab_size}")

    # -- tokenizer passthroughs ---------------------------------------------------

    @property
    def context_length(self) -> int:
        return self.tokenizer.context_length

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    @property
    def cased_tokens(self) -> bool:
        return self.tokenizer.cased

    @property
    def start_token_id(self):
        return self.tokenizer.start_token_id

    @property
    def end_token_id(self):
        return self.tokenizer.end_token_id

    @property
    def pad_token_id(self):
        return self.tokenizer.pad_token_id

    @property
    def token_dtype(self):
        return self.tokenizer.token_dtype

    def tokenize(self, text, max_tokens=None, output_dict=False):
        return self.tokenizer.tokenize(text, max_tokens=max_tokens, output_dict=output_dict)

    def detokenize(self, token_ids):
        return self.tokenizer.detokenize(token_ids)

    def get_tokenize_details(self, text, max_tokens=None, token_id_set=False):
        return self.tokenizer.get_tokenize_details(text, max_tokens=max_tokens,
                                                   token_id_set=token_id_set)

    # -- target config ------------------------------------------------------------

    def create_target_config(self, targets: Sequence[str], **kwargs) -> TargetConfig:
        return create_target_config(self.tokenizer, targets,
                                    batch_size=self.tokenizer_batch_size, **kwargs)

    def configure_target(self, target_config: TargetConfig, target_vocab: Sequence[str]):
        self.target_tokenizer = TargetTokenizer(self.tokenizer, target_config, check=self.check)
        self.target_vocab = tuple(target_vocab)

    @property
    def target_config(self) -> Optional[TargetConfig]:
        return self.target_tokenizer.target_config if self.target_tokenizer else None

    def tokenize_target(self, text, max_tokens=None):
        if not self.target_tokenizer:
            raise ValueError("Tokenizing a target noun requires a target configuration to be set")
        return self.target_tokenizer.tokenize_target(text, max_tokens=max_tokens)

    def detokenize_target(self, token_ids):
        if not self.target_tokenizer:
            raise ValueError("Detokenizing a target noun requires a target configuration to be set")
        return self.target_tokenizer.detokenize_target(token_ids)

    # -- configuration hashing (cache compatibility, ref embedders.py:262-278) -----

    def get_configuration(self, main_config: bool, target_config: bool,
                          target_exclude: Optional[set] = None,
                          target_override: Optional[dict] = None) -> dict:
        configuration = self.configuration.copy() if main_config else {}
        if target_config:
            if self.target_tokenizer is None:
                raise ValueError("Cannot get configuration including target config: none set")
            tc = self.target_tokenizer.target_config.as_jsonable()
            if target_exclude is not None:
                tc = {k: v for k, v in tc.items() if k not in target_exclude}
            if target_override is not None:
                tc.update(target_override)
            configuration["target_config"] = tc
        return configuration

    def get_configuration_hash(self, main_config: bool, target_config: bool,
                               target_exclude: Optional[set] = None,
                               target_override: Optional[dict] = None,
                               hexdigest: bool = False, algorithm: str = "sha256"
                               ) -> Union[bytes, str]:
        configuration = self.get_configuration(main_config, target_config,
                                               target_exclude, target_override)
        h = hashlib.new(algorithm,
                        json.dumps(configuration, separators=(",", ":"), sort_keys=True).encode())
        return h.hexdigest() if hexdigest else h.digest()

    # -- inference ---------------------------------------------------------------

    @contextlib.contextmanager
    def inference_model(self, release: bool = True):
        """Temporarily load the towers if they are not loaded."""
        if self.is_model_loaded():
            yield
        else:
            try:
                self.load_model()
                yield
            finally:
                self.unload_model()

    @contextlib.contextmanager
    def inference_mode(self):
        with torch.inference_mode():
            yield

    def load_model(self) -> bool:
        raise NotImplementedError

    def unload_model(self) -> bool:
        raise NotImplementedError

    def is_model_loaded(self) -> bool:
        raise NotImplementedError

    def set_mesh(self, mesh, mode: str = "dp") -> None:
        """Multi-device inference over a parallel.mesh.Mesh; host-side embedders
        (the hash and structured test embedders) ignore it."""

    def inference_tokens(self, tokens_dict: dict) -> np.ndarray:
        """Tokenized texts ({"input_ids": (B,S)}) → unit-norm float32 embeddings."""
        raise NotImplementedError

    def inference_text(self, text: Union[str, Sequence[str]],
                       max_tokens: Optional[int] = None) -> np.ndarray:
        """Texts → unit-norm float32 embeddings."""
        return self.inference_tokens(self.tokenize(text, max_tokens=max_tokens, output_dict=True))

    def inference_image(self, images: np.ndarray) -> np.ndarray:
        """Preprocessed (B,S,S,3) float32 images → unit-norm float32 embeddings."""
        raise NotImplementedError

    def get_image_transform(self) -> Callable:
        raise NotImplementedError


def tower_modules(arch: EmbedderArch):
    """(vision_model, text_model) modules for a registry arch: the single
    family-dispatch point. Each has `init_random(generator)`."""
    if arch.family == "align":
        from novic_tpu_torch.embedders.align import BertTextTower, EfficientNetTower

        return EfficientNetTower(arch.vision), BertTextTower(arch.text)
    from novic_tpu_torch.embedders.vit import TextTransformer, VisionTransformer

    if arch.family == "eva02":
        from novic_tpu_torch.embedders.eva import EvaVisionTransformer

        return EvaVisionTransformer(arch.vision), TextTransformer(arch.text)
    return VisionTransformer(arch.vision), TextTransformer(arch.text)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class TorchEmbedder(Embedder):
    """PyTorch towers for a registered architecture of any family (the
    counterpart of JaxEmbedder). Built directly with a replaced arch it serves
    other tower configurations, e.g. the int8 mode:
    TorchEmbedder(spec=..., arch=dataclasses.replace(arch, vision=dataclasses.replace(
    arch.vision, quant="int8:pallas")), ...).

    Random towers (no weights_path) are drawn on the CPU from `seed`, the same
    on every device; `init_on_device=True` builds and draws them on the
    embedder's device instead (a CUDA generator: other values than the CPU's),
    for towers too large to draw on the host.

    `set_mesh` spreads inference over the ranks of a parallel.mesh.Mesh (one
    process per device, this embedder on its rank's device)."""

    def __init__(self, *, spec: str, arch: EmbedderArch, load_model: bool, check: bool,
                 weights_path: Optional[str], tokenizer: Optional[TextTokenizer],
                 compute_dtype: str, seed: int, device: Union[str, torch.device] = "cuda",
                 bpe_merges_path: Optional[str] = None, init_on_device: bool = False, **sizes):
        if compute_dtype != arch.vision.compute_dtype:
            arch = dataclasses.replace(
                arch, vision=dataclasses.replace(arch.vision, compute_dtype=compute_dtype),
                text=dataclasses.replace(arch.text, compute_dtype=compute_dtype))
        self.arch = arch
        self.device = resolve(device)
        self.weights_path = weights_path
        self.seed = seed
        self.init_on_device = init_on_device
        self._vision = self._text = None
        self._mesh, self._mesh_mode = None, "dp"
        if tokenizer is None:
            tokenizer = self._build_tokenizer(arch, bpe_merges_path)
        configuration = {
            "spec": spec,
            "family": arch.family,
            "vision": dataclasses.asdict(arch.vision),
            "text": dataclasses.asdict(arch.text),
            "preprocess": dataclasses.asdict(arch.preprocess),
            "weights": os.path.basename(weights_path) if weights_path else "random",
        }
        super().__init__(spec=spec, configuration=configuration, tokenizer=tokenizer,
                         embed_dim=arch.vision.embed_dim, check=check,
                         config_class="JaxEmbedder", **sizes)
        if load_model:
            self.load_model()

    @staticmethod
    def _build_tokenizer(arch: EmbedderArch, bpe_merges_path: Optional[str]) -> TextTokenizer:
        """The tokenizer JaxEmbedder._build_tokenizer picks for `arch`, branch
        for branch: the real one when its file is named and exists, else (with
        the same warning) the word-level test tokenizer."""
        if arch.tokenizer == "clip_bpe":
            path = bpe_merges_path or os.environ.get("NOVIC_CLIP_BPE", "")
            if path and os.path.isfile(path):
                from novic_tpu_torch.text.clip_bpe import CLIPBPETokenizer

                return CLIPBPETokenizer(path, context_length=arch.text.context_length)
            log.warning(
                "CLIP BPE merges file not available (set NOVIC_CLIP_BPE or pass "
                "bpe_merges_path) => falling back to the word-level test tokenizer; "
                "text embeddings will NOT match released checkpoints")
        elif arch.tokenizer == "sentencepiece":
            path = bpe_merges_path or os.environ.get("NOVIC_SIGLIP_SPM", "")
            if path and os.path.isfile(path):
                from novic_tpu_torch.text.sentencepiece import SentencePieceTokenizer

                return SentencePieceTokenizer(path, context_length=arch.text.context_length)
            log.warning(
                "SentencePiece .model asset not available (set NOVIC_SIGLIP_SPM or "
                "pass bpe_merges_path) => falling back to the word-level test "
                "tokenizer; text embeddings will NOT match released checkpoints")
        elif arch.tokenizer == "bert":
            # ALIGN: BERT-uncased WordPiece with [SEP] kept as the end token
            path = bpe_merges_path or os.environ.get("NOVIC_BERT_VOCAB", "")
            if path and os.path.isfile(path):
                from novic_tpu_torch.text.wordpiece import BertWordPieceTokenizer

                return BertWordPieceTokenizer(path, context_length=arch.text.context_length,
                                              keep_sep=True)
            log.warning(
                "BERT WordPiece vocab.txt asset not available (set NOVIC_BERT_VOCAB "
                "or pass bpe_merges_path) => falling back to the word-level test "
                "tokenizer; text embeddings will NOT match released checkpoints")
        elif arch.tokenizer == "wordpiece":
            # CLIPA: BERT-uncased WordPiece with [SEP] stripped
            path = bpe_merges_path or os.environ.get("NOVIC_BERT_VOCAB", "")
            if path and os.path.isfile(path):
                from novic_tpu_torch.text.wordpiece import BertWordPieceTokenizer

                return BertWordPieceTokenizer(path, context_length=arch.text.context_length)
            log.warning(
                "BERT WordPiece vocab.txt asset not available (set NOVIC_BERT_VOCAB "
                "or pass bpe_merges_path) => falling back to the word-level test "
                "tokenizer; text embeddings will NOT match released checkpoints")
        return SimpleWordTokenizer(words=(), context_length=arch.text.context_length)

    # -- model lifecycle ---------------------------------------------------------

    def set_mesh(self, mesh, mode: str = "dp") -> None:
        """Multi-device inference over a parallel.mesh.Mesh (None: one device).

        mode='dp'    Mesh('data'): towers replicated; each rank embeds its
                     slice of the batch (padded with zero rows to a multiple
                     of the axis size) and the rows are all-gathered, so every
                     rank returns the whole output.
        mode='tp'    Mesh('model'): Megatron tensor parallelism
                     (parallel/tp.py): attention heads and MLP hidden dims
                     cut over the ranks, two all-reduces per block; every
                     rank runs the whole batch.
        mode='dp_tp' 2-D Mesh('data', 'model'): batch on 'data', TP on 'model'.

        Every rank calls the embedder with the same inputs. Loaded towers are
        reloaded when their tensor-parallel layout changes."""
        if mode not in ("dp", "tp", "dp_tp"):
            raise ValueError(f"Unknown mesh mode: {mode}")
        if mesh is not None and "tp" in mode:
            if self.arch.family == "align":
                raise ValueError(
                    "Tensor parallelism is not supported for the ALIGN conv "
                    "tower (parallel/tp.py cuts transformer params); "
                    "use mode='dp'")
            if getattr(self.arch.vision, "quant", "") or self.arch.text.quant:
                raise ValueError("Tensor parallelism is not supported in the int8 quant "
                                 "mode; use mode='dp'")
            validate_tp_divisibility(self.arch.vision, self.arch.text,
                                     axis_size=mesh.axis_size("model"))
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"Mesh device {mesh.device} is not the embedder's {self.device}")
        was_tp = self._tp_group() is not None
        self._mesh, self._mesh_mode = mesh, mode
        if self.is_model_loaded() and (was_tp or self._tp_group() is not None):
            self.unload_model()
            self.load_model()

    def _tp_group(self):
        """The 'model' axis group the towers are cut over, or None."""
        if self._mesh is None or "tp" not in self._mesh_mode:
            return None
        m = self._mesh
        return TPGroup(m.group("model"), m.axis_index("model"), m.axis_size("model"))

    def load_model(self) -> bool:
        if self._vision is not None:
            return False
        if self.init_on_device and not self.weights_path:
            with self.device:
                vision, text = tower_modules(self.arch)
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self._vision, self._text = vision.init_random(gen).eval(), text.init_random(gen).eval()
            log.warning("No tower weights provided => using random initialization on "
                        f"{self.device} (perf benchmarking / testing only)")
            self._shard_towers()
            return True
        vision, text = tower_modules(self.arch)
        if self.weights_path:
            from novic_tpu_torch.bridge import load_tree
            from novic_tpu_torch.embedders.convert import load_params_npz

            vision_params, text_params = load_params_npz(self.weights_path)
            load_tree(vision, vision_params)
            load_tree(text, text_params)
            log.info(f"Loaded converted tower weights: {self.weights_path}")
        else:
            # One CPU generator, vision first: a seed gives the same towers on every device
            gen = torch.Generator().manual_seed(self.seed)
            vision.init_random(gen)
            text.init_random(gen)
            log.warning("No tower weights provided => using random initialization "
                        "(perf benchmarking / testing only)")
        self._vision = vision.to(self.device).eval()
        self._text = text.to(self.device).eval()
        self._shard_towers()
        return True

    def _shard_towers(self) -> None:
        """Cut the loaded towers to this rank's shards under tensor parallelism."""
        tp = self._tp_group()
        if tp is not None:
            shard_tower(self._vision, tp)
            shard_tower(self._text, tp)
            log.info(f"Towers cut over {tp.size} tensor-parallel ranks (rank {tp.rank})")

    def unload_model(self) -> bool:
        if self._vision is None:
            return False
        self._vision = self._text = None
        log.info("Unloaded embedder towers")
        return True

    def is_model_loaded(self) -> bool:
        return self._vision is not None

    # -- inference ---------------------------------------------------------------

    def _run(self, tower, x: torch.Tensor) -> torch.Tensor:
        """Unit-norm tower outputs; under data parallelism this rank embeds its
        slice of the batch (zero rows pad it to a multiple of the 'data' axis)
        and the slices are all-gathered in rank order."""
        mesh = self._mesh
        with torch.inference_mode():
            if mesh is None or "dp" not in self._mesh_mode:
                return _unit(tower(x))
            b = x.shape[0]
            pad = -b % mesh.axis_size("data")
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            return gather_rows(_unit(tower(shard_rows(x, mesh))), mesh)[:b]

    def embed_image_tensor(self, images: torch.Tensor) -> torch.Tensor:
        """(B,S,S,3) float32 tensor on the embedder's device → (B,F) unit-norm."""
        if self._vision is None:
            raise RuntimeError("Embedder towers not loaded")
        return self._run(self._vision, images)

    def embed_token_tensor(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B,S) int token ids on the embedder's device → (B,F) unit-norm."""
        if self._text is None:
            raise RuntimeError("Embedder towers not loaded")
        return self._run(self._text, token_ids)

    def inference_tokens(self, tokens_dict: dict) -> np.ndarray:
        """Token ids padded to the context length with the pad id, the batch
        padded with zero rows to inference_batch_size (as the JAX embedder
        does) → unit-norm float32 embeddings (numpy)."""
        token_ids = np.asarray(tokens_dict["input_ids"])
        B, S = token_ids.shape
        ctx = self.context_length
        if S > ctx:
            raise ValueError(f"Token sequences longer than context length: {S} > {ctx}")
        rows = max(B, self.inference_batch_size)
        padded = np.zeros((rows, ctx), dtype=np.int32)
        padded[:B] = self.pad_token_id
        padded[:B, :S] = token_ids
        ids = torch.from_numpy(padded).to(self.device)
        return self.embed_token_tensor(ids)[:B].cpu().numpy()

    def inference_image(self, images: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        """Preprocessed (B,S,S,3) float32 images (numpy, or a tensor from
        get_image_transform) → unit-norm float32 embeddings (numpy)."""
        with trace.span("embed.forward"):
            if isinstance(images, np.ndarray):
                images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
            e = self.embed_image_tensor(images.to(self.device))
        with trace.span("embed.wait"):  # the host blocks until the tower's work ends
            return e.cpu().numpy()

    def get_image_transform(self) -> Callable:
        """images → (B,S,S,3) float32 tensor on the embedder's device. uint8
        frames already at the final size are copied as uint8 and normalised
        on the device (bit-identical to the host path); others go through PIL."""
        cfg = self.arch.preprocess

        def transform(images):
            if not isinstance(images, (list, tuple)):
                images = [images]
            with trace.span("embed.frames"):
                if is_final_size_batch(images, cfg):
                    frames = torch.from_numpy(np.stack(images)).to(self.device)
                    return preprocess_frames(frames, cfg)
                return torch.from_numpy(preprocess_pil_host(images, cfg)).to(self.device)

        return transform


class HashEmbedder(Embedder):
    """Deterministic test embedder ('test:<dim>'): unit vectors derived from a
    BLAKE2 hash of the text / image bytes (the same bytes as the JAX package's)."""

    def __init__(self, *, spec: str, embed_dim: int, check: bool = False, tokenizer=None,
                 **sizes):
        tok = tokenizer if tokenizer is not None else SimpleWordTokenizer(words=(), context_length=77)
        super().__init__(spec=spec, configuration={"spec": spec, "embed_dim": embed_dim},
                         tokenizer=tok, embed_dim=embed_dim, check=check,
                         config_class=type(self).__name__, **sizes)
        self._loaded = True

    def load_model(self) -> bool:
        was = self._loaded
        self._loaded = True
        return not was

    def unload_model(self) -> bool:
        was = self._loaded
        self._loaded = False
        return was

    def is_model_loaded(self) -> bool:
        return self._loaded

    def _hash_embed(self, data: bytes) -> np.ndarray:
        seed = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(self.embed_dim,)).astype(np.float32)
        return v / np.linalg.norm(v)

    def inference_text(self, text, max_tokens=None) -> np.ndarray:
        texts = [text] if isinstance(text, str) else list(text)
        return np.stack([self._hash_embed(t.encode("utf-8")) for t in texts])

    def inference_tokens(self, tokens_dict: dict) -> np.ndarray:
        ids = np.asarray(tokens_dict["input_ids"])
        return np.stack([self._hash_embed(row.tobytes()) for row in ids])

    def inference_image(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images)
        return np.stack([self._hash_embed(np.ascontiguousarray(img).tobytes())
                         for img in images])

    def get_image_transform(self) -> Callable:
        cfg = PreprocessConfig(size=32)

        def transform(images):
            if not isinstance(images, (list, tuple)):
                images = [images]
            return preprocess_pil_host(images, cfg)

        return transform
