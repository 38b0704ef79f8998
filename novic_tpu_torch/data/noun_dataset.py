"""Procedural noun text dataset: vocab JSON × prompt templates × hypernyms.

Capability parity with the reference NounDataset (reference noun_dataset.py):

* Vocab JSON entries ``id, target_noun, pretty_noun, singulars[], plurals[],
  singulars_freq[], plurals_freq[], hypernyms[]`` with validation, frequency
  threshold filtering and hypernym target resolution (ref :97-144).
* Prompt JSON: collections of ``[freq, template]`` with
  {noun}/{singular}/{plural}/{article_*} fields and hypernym suffix
  collections including the null template (ref :148-254).
* Pure index arithmetic over two sample-ID spaces — FSID (frequency-weighted,
  what training iterates) and USID (unique texts, what gets embedded/cached) —
  via cumulative maps + searchsorted, O(log n) decode with nothing
  materialized (ref :376-431 get_sample_details, :436-449 text assembly,
  :455-501 sequential generator).
* Optional binary noun cache of [embed | target | mask] per USID, path keyed
  by an MD5 of the generating configuration, with a randomized re-embedding
  sanity check on load (ref :663-849).

The port's copy of novic_tpu.data.noun_dataset: the same counts, texts,
sample streams and loader batches for the same seed, and the same noun-cache
file (name and bytes), so either package reads the other's. The host code is
unchanged; the embedder's text tower runs on its device (the card by
default), and the loader hands numpy batches to the training loop, which
copies them to the card.
The a/an article fast path lives in novic_tpu_torch.utils.misc.make_indefinite.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import random
import string
from typing import Iterable, Optional, Union

import numpy as np

from novic_tpu_torch.data.config import DataConfig, LoaderInfo
from novic_tpu_torch.data.dataset import EmbeddingDataset
from novic_tpu_torch.utils.logger import log
from novic_tpu_torch.utils.misc import make_indefinite


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    template: str        # with exactly one '{noun}' field, ends with '.'
    freq: int
    need_article: bool   # whether to prefix the noun with a/an
    need_hyp_comma: bool  # whether a hypernym suffix needs a leading comma


@dataclasses.dataclass(frozen=True)
class HypernymTemplate:
    template: str          # with exactly one '{target}' field (suffix text)
    template_comma: str
    need_article: bool
    freq_dist: tuple       # per num_hypernyms: tuple of per-hypernym freqs


@dataclasses.dataclass(frozen=True)
class UniqueSample:
    fsid: int
    usid: int
    freq: int
    vocab: dict
    noun: str
    text: str
    target: str


# Minimal built-in prompt set for tests/smoke runs (the real recipe loads the
# user's prompts.json with the ImageNet1K/CIFAR collections, ref
# config/train.yaml:177-181).
BUILTIN_PROMPTS = {
    "prompts": {
        "Basic": [
            [2, "a photo of {article_singular}"],
            [1, "a picture showing {article_singular}"],
            [1, "an image of many {plural}"],
            [1, "{noun}"],
        ],
    },
    "hypernyms": {
        "None": [[1, None]],
        "Type": [[2, None], [1, " which is a type of {target}"]],
    },
}


class NounDataset(EmbeddingDataset):

    def __init__(
        self,
        embedder,                                        # Embedder (tokenizer + optional towers)
        vocab_path: Optional[str] = None,                # vocab JSON path (or vocab_json directly)
        vocab_json: Optional[list] = None,
        prompt_path: Optional[str] = None,               # prompt JSON path (or prompt_json)
        prompt_json: Optional[dict] = None,
        prompt_collection: Union[str, Iterable[str]] = "Basic",
        hypernym_collection: Union[str, Iterable[str]] = "None",
        vocab_thres: int = 0,
        cache_dir: Optional[str] = None,
        force_recache: bool = False,
        check_consistent: bool = False,
        check_print: int = 0,
        use_targets: Optional[bool] = None,
    ):
        self.embedder = embedder
        if vocab_json is None:
            if vocab_path is None:
                raise ValueError("Either vocab_path or vocab_json must be provided")
            with open(vocab_path) as f:
                vocab_json = json.load(f)
            log.info(f"Loaded {len(vocab_json)} target nouns from vocab JSON: {vocab_path}")
        self.vocab_json = [dict(v) for v in vocab_json]
        self.vocab_path = vocab_path

        # -- vocab validation + derived fields (ref noun_dataset.py:97-144) ----
        self.vocab_by_id: dict[int, dict] = {}
        for vocab in self.vocab_json:
            vocab_id = vocab["id"]
            if not isinstance(vocab_id, int) or vocab_id < 0:
                raise ValueError(f"Bad vocab ID in vocab JSON: {vocab_id}")
            if vocab_id in self.vocab_by_id:
                raise ValueError(f"Duplicate vocab ID in vocab JSON: {vocab_id}")
            self.vocab_by_id[vocab_id] = vocab
            if not vocab["target_noun"]:
                raise ValueError(f"Empty target noun at vocab ID {vocab_id}")
            singulars, plurals = vocab["singulars"], vocab["plurals"]
            sfreq, pfreq = vocab["singulars_freq"], vocab["plurals_freq"]
            if len(singulars) != len(sfreq) or len(plurals) != len(pfreq):
                raise ValueError(f"Vocab ID {vocab_id} has non-matching noun/freq counts")
            if len(singulars) + len(plurals) < 1:
                raise ValueError(f"Vocab ID {vocab_id} lists no singular or plural forms")
            if any(not isinstance(f, int) or f < 1 for f in itertools.chain(sfreq, pfreq)):
                raise ValueError(f"Vocab ID {vocab_id} has invalid frequencies")
            for noun in itertools.chain((vocab["target_noun"], vocab.get("pretty_noun", "x")),
                                        singulars, plurals):
                if noun != " ".join(noun.split()):
                    raise ValueError(f"Noun for vocab ID {vocab_id} has stray whitespace")
            vocab["singulars_freq_sum"] = sum(sfreq)
            vocab["plurals_freq_sum"] = sum(pfreq)
            vocab["singulars_id"] = tuple(i for i, f in enumerate(sfreq) for _ in range(f))
            vocab["plurals_id"] = tuple(i for i, f in enumerate(pfreq) for _ in range(f))

        self.vocab_thres = vocab_thres
        if vocab_thres > 0:
            self.vocab_json = [v for v in self.vocab_json
                               if v["singulars_freq_sum"] + v["plurals_freq_sum"] > vocab_thres]
            log.info(f"Filtered vocab down to {len(self.vocab_json)} target nouns "
                     f"(freq > {vocab_thres})")
        self.target_nouns = tuple(v["target_noun"] for v in self.vocab_json)

        max_hypernyms = 0
        for vocab in self.vocab_json:
            hypernyms = vocab.get("hypernyms", [])
            if len(set(hypernyms)) < len(hypernyms):
                raise ValueError(f"Vocab ID {vocab['id']} has duplicate hypernym(s)")
            max_hypernyms = max(max_hypernyms, len(hypernyms))
            if any(h not in self.vocab_by_id for h in hypernyms):
                raise ValueError(f"Vocab ID {vocab['id']} has invalid hypernym(s)")
            vocab["hypernyms"] = list(hypernyms)
            vocab["hypernym_targets"] = tuple(self.vocab_by_id[h]["target_noun"] for h in hypernyms)

        # -- prompt parsing (ref noun_dataset.py:148-254) ------------------------
        if prompt_json is None:
            if prompt_path is None:
                prompt_json = BUILTIN_PROMPTS
            else:
                with open(prompt_path) as f:
                    prompt_json = json.load(f)
        prompts_json = prompt_json["prompts"]
        hypernyms_json = prompt_json["hypernyms"]

        self.prompt_collection = self._parse_collection(prompt_collection, prompts_json)
        prompt_freq_map: dict[str, int] = {}
        for collection in self.prompt_collection:
            for freq, template in prompts_json[collection]:
                if not isinstance(freq, int) or freq < 0:
                    raise ValueError(f"Prompt frequency must be a non-negative integer, got {freq}")
                if freq >= 1:
                    prompt_freq_map[template] = prompt_freq_map.get(template, 0) + freq

        formatter = string.Formatter()
        singular_prompts, plural_prompts = [], []
        for template, freq in prompt_freq_map.items():
            template = " ".join(template.split())
            if not template:
                raise ValueError("Empty prompt template")
            if template[-1] != ".":
                template += "."
            parts = tuple(formatter.parse(template))
            if any(spec or conv for _, _, spec, conv in parts):
                raise ValueError(f"Prompt template fields cannot have format spec: {template}")
            fields = set(name for _, name, _, _ in parts)
            if len(fields) != len(parts):
                raise ValueError(f"Prompt template cannot specify a field multiple times: {template}")
            fields.discard(None)
            if len(fields) != 1:
                raise ValueError(f"Must have exactly one prompt template field: {template}")
            ptype = fields.pop()
            field = f"{{{ptype}}}"
            after = template[template.rfind(field) + len(field)]
            need_hyp_comma = after not in (".", ",", "?", "!", ":", ";")
            if ptype != "noun":
                template = template.replace(field, "{noun}")
            need_article = ptype.startswith("article_")
            if need_article:
                ptype = ptype[8:]
            if ptype == "singular":
                singular_prompts.append(PromptTemplate(template, freq, need_article, need_hyp_comma))
            elif ptype == "plural":
                plural_prompts.append(PromptTemplate(template, freq, False, need_hyp_comma))
            elif ptype == "noun":
                singular_prompts.append(PromptTemplate(template, freq, need_article, need_hyp_comma))
                plural_prompts.append(PromptTemplate(template, freq, False, need_hyp_comma))
            else:
                raise ValueError(f"Unrecognised prompt template field {{{ptype}}}: {template}")
        self.singular_prompts = tuple(singular_prompts)
        self.plural_prompts = tuple(plural_prompts)
        log.info(f"Compiled {len(singular_prompts)} singular and {len(plural_prompts)} plural "
                 f"prompt templates from: {' | '.join(self.prompt_collection)}")

        # -- hypernym templates + frequency distribution (ref :210-254) ----------
        self.hypernym_collection = self._parse_collection(hypernym_collection, hypernyms_json)
        hypernym_freq_map: dict[Optional[str], int] = {}
        for collection in self.hypernym_collection:
            for freq, template in hypernyms_json[collection]:
                if not isinstance(freq, int) or freq < 0:
                    raise ValueError(f"Hypernym frequency must be a non-negative integer, got {freq}")
                if freq >= 1:
                    hypernym_freq_map[template] = hypernym_freq_map.get(template, 0) + freq
        if None not in hypernym_freq_map:
            raise ValueError("Exactly one hypernym template entry should be null/None")
        no_hypernym_freq = hypernym_freq_map.pop(None)
        num_templates = len(hypernym_freq_map)
        # Distribute each template's freq round-robin over a noun's hypernyms
        hypernym_template_freq_map: dict[int, tuple] = {0: tuple(() for _ in range(num_templates))}
        for n in range(1, max_hypernyms + 1):
            dist = tuple([0] * n for _ in range(num_templates))
            i_h = 0
            for i_t, tfreq in enumerate(hypernym_freq_map.values()):
                for _ in range(tfreq):
                    dist[i_t][i_h] += 1
                    i_h = (i_h + 1) % n
            hypernym_template_freq_map[n] = tuple(tuple(d) for d in dist)
        self.no_hypernym_freqs = ((no_hypernym_freq + sum(hypernym_freq_map.values()),)
                                  + (no_hypernym_freq,) * max_hypernyms)

        hypernym_prompts = []
        for i, (template, freq) in enumerate(hypernym_freq_map.items()):
            template = " ".join(template.split())
            if not template:
                raise ValueError("Empty hypernym template")
            parts = tuple(formatter.parse(template))
            fields = set(name for _, name, _, _ in parts)
            fields.discard(None)
            if len(fields) != 1:
                raise ValueError(f"Must have exactly one hypernym template field: {template}")
            htype = fields.pop()
            need_article = htype.startswith("article_")
            if need_article:
                htype = htype[8:]
                template = template.replace("{article_", "{")
            if htype != "target":
                raise ValueError(f"Unrecognised hypernym template field {{{htype}}}: {template}")
            hypernym_prompts.append(HypernymTemplate(
                template=template, template_comma=template + ",",  # trailing comma when text continues (ref :246)
                need_article=need_article,
                freq_dist=tuple(dist[i] for dist in hypernym_template_freq_map.values())))
        self.hypernym_prompts = tuple(hypernym_prompts)

        # -- index maps (ref :258-295) --------------------------------------------
        hypernym_block_map, unique_hypernym_map, unique_hypernyms = [], [], []
        for n in range(max_hypernyms + 1):
            block: list = [(None, None, 0, self.no_hypernym_freqs[n], rep)
                           for rep in range(self.no_hypernym_freqs[n])]
            unique: list = [(None, None)]
            for hyp in self.hypernym_prompts:
                for hid, freq in enumerate(hyp.freq_dist[n]):
                    if freq > 0:
                        for rep in range(freq):
                            block.append((hyp, hid, len(unique), freq, rep))
                        unique.append((hyp, hid))
            hypernym_block_map.append(tuple(block))
            unique_hypernym_map.append(tuple(unique))
            unique_hypernyms.append(len(unique))
        self.hypernym_block_map = tuple(hypernym_block_map)
        self.unique_hypernym_map = tuple(unique_hypernym_map)
        self.unique_hypernyms = tuple(unique_hypernyms)

        total_freq_singular_prompts = sum(p.freq for p in self.singular_prompts)
        total_freq_plural_prompts = sum(p.freq for p in self.plural_prompts)
        self.total_freq_hypernyms = self.no_hypernym_freqs[0]
        total_freq_singular = total_freq_singular_prompts * self.total_freq_hypernyms
        total_freq_plural = total_freq_plural_prompts * self.total_freq_hypernyms
        self.num_tids = len(self.vocab_json)
        self.target_fsid_map = np.fromiter(
            itertools.accumulate(
                (freq for v in self.vocab_json
                 for freq in (total_freq_singular * v["singulars_freq_sum"],
                              total_freq_plural * v["plurals_freq_sum"])), initial=0),
            dtype=np.int64, count=2 * self.num_tids + 1)
        self.target_usid_map = np.fromiter(
            itertools.accumulate(
                (self.unique_hypernyms[len(v["hypernyms"])] * n for v in self.vocab_json
                 for n in (len(self.singular_prompts) * len(v["singulars"]),
                           len(self.plural_prompts) * len(v["plurals"]))), initial=0),
            dtype=np.int64, count=2 * self.num_tids + 1)
        self.num_fsids = int(self.target_fsid_map[-1])
        self.num_usids = int(self.target_usid_map[-1])
        self.prompt_block_map_singular = tuple(
            (pid, p, rep) for pid, p in enumerate(self.singular_prompts) for rep in range(p.freq))
        self.prompt_block_map_plural = tuple(
            (pid, p, rep) for pid, p in enumerate(self.plural_prompts) for rep in range(p.freq))
        log.info(f"Noun dataset: {self.num_tids} TIDs, {self.num_fsids} FSIDs, "
                 f"{self.num_usids} USIDs")

        self.cache_dir = os.path.abspath(os.path.expanduser(cache_dir)) if cache_dir else None
        self.use_cache = cache_dir is not None
        self.recache = force_recache
        self.cache: Optional[NounCache] = None

        super().__init__(
            target_config=None,  # configured later via embedder.target_config
            nominal_data_config=DataConfig(
                use_weights=False, unit_weights=True, multi_target=False, multi_first=False,
                full_targets=True, fixed_multi_length=True, multi_length=1),
            strict_data_config_fields={"multi_length"},
            num_items=self.num_fsids,
            targets=self.target_nouns,
            use_targets=True if use_targets is None else use_targets,
        )

        self.check_consistent = check_consistent
        self.check(max_print_usid=check_print)

    # -- helpers ----------------------------------------------------------------

    @staticmethod
    def _parse_collection(collection, allowed) -> tuple[str, ...]:
        if isinstance(collection, str):
            collection = tuple(c.strip() for c in collection.split("|"))
        else:
            collection = tuple(collection)
        if any(c not in allowed for c in collection):
            raise ValueError(f"Collection specifier contains invalid values: {collection}")
        return collection

    make_indefinite = staticmethod(make_indefinite)

    def check(self, max_print_usid: int = 0):
        """Cross-validate indexed access against the sequential generator
        (ref noun_dataset.py:335-355,487-501)."""
        if self.check_consistent or max_print_usid > 0:
            for sample in self.unique_sample():
                if sample.usid < max_print_usid:
                    print(f"{sample.fsid}:{sample.usid}: {sample.freq:2d} x {sample.text}")
                elif not self.check_consistent:
                    return

    # -- index decode (ref noun_dataset.py:376-431) --------------------------------

    def get_sample_details(self, fsid=None, usid=None):
        if usid is not None:
            if usid < 0 or usid >= self.num_usids:
                raise IndexError("USID out of range")
            idx = int(self.target_usid_map.searchsorted(usid, side="right")) - 1
            is_singular = not (idx & 1)
            rel = usid - int(self.target_usid_map[idx])
            vocab = self.vocab_json[idx >> 1]
            nouns = vocab["singulars" if is_singular else "plurals"]
            num_h = len(vocab["hypernym_targets"])
            rel, noun_id = divmod(rel, len(nouns))
            prompt_id, unique_hid = divmod(rel, self.unique_hypernyms[num_h])
            prompt = (self.singular_prompts if is_singular else self.plural_prompts)[prompt_id]
            hypernym, hid = self.unique_hypernym_map[num_h][unique_hid]
            hyp_target = vocab["hypernym_targets"][hid] if hid is not None else None
        else:
            if fsid < 0 or fsid >= self.num_fsids:
                raise IndexError("FSID out of range")
            idx = int(self.target_fsid_map.searchsorted(fsid, side="right")) - 1
            is_singular = not (idx & 1)
            rel = fsid - int(self.target_fsid_map[idx])
            vocab = self.vocab_json[idx >> 1]
            freq_sum = vocab["singulars_freq_sum" if is_singular else "plurals_freq_sum"]
            num_h = len(vocab["hypernym_targets"])

            prompt_block_size = freq_sum * self.total_freq_hypernyms
            prompt_block_id, off = divmod(rel, prompt_block_size)
            prompt_id, prompt, prompt_rep = (
                self.prompt_block_map_singular if is_singular else self.prompt_block_map_plural
            )[prompt_block_id]
            off += prompt_rep * prompt_block_size

            hyp_block_size = prompt.freq * freq_sum
            hyp_block_id, off = divmod(off, hyp_block_size)
            hypernym, hid, unique_hid, hyp_freq, hyp_rep = self.hypernym_block_map[num_h][hyp_block_id]
            off += hyp_rep * hyp_block_size
            hyp_target = vocab["hypernym_targets"][hid] if hid is not None else None

            noun_block_size = prompt.freq * hyp_freq
            noun_block_id = off // noun_block_size
            noun_id = vocab["singulars_id" if is_singular else "plurals_id"][noun_block_id]

            nouns = vocab["singulars" if is_singular else "plurals"]
            usid = int(self.target_usid_map[idx]) + noun_id + len(nouns) * (
                unique_hid + self.unique_hypernyms[num_h] * prompt_id)

        return usid, vocab, vocab["target_noun"], is_singular, nouns, prompt, hypernym, hyp_target, noun_id

    def get_sample_usid(self, fsid: int) -> int:
        return self.get_sample_details(fsid)[0]

    def get_sample_text(self, fsid=None, usid=None, details=None) -> tuple[str, str]:
        if details is None:
            details = self.get_sample_details(fsid=fsid, usid=usid)
        usid, vocab, target_noun, is_singular, nouns, prompt, hypernym, hyp_target, noun_id = details
        noun = nouns[noun_id]
        if hypernym is None:
            if prompt.need_article:
                noun = make_indefinite(noun)
        else:
            template = hypernym.template_comma if prompt.need_hyp_comma else hypernym.template
            suffix = template.format(
                target=make_indefinite(hyp_target) if hypernym.need_article else hyp_target)
            noun = make_indefinite(noun, suffix=suffix) if prompt.need_article else noun + suffix
        return prompt.template.format(noun=noun), target_noun

    def unique_sample(self):
        """Sequential generator over all unique samples (ref noun_dataset.py:455-501),
        optionally cross-validating the O(log n) indexed decode."""
        fsid = usid = 0
        for vocab in self.vocab_json:
            target = vocab["target_noun"]
            hyp_targets = vocab["hypernym_targets"]
            num_h = len(hyp_targets)
            for prompts, nouns, freqs in ((self.singular_prompts, vocab["singulars"], vocab["singulars_freq"]),
                                          (self.plural_prompts, vocab["plurals"], vocab["plurals_freq"])):
                for prompt in prompts:
                    hyp_data = [(None, self.no_hypernym_freqs[num_h])]
                    for hyp in self.hypernym_prompts:
                        template = hyp.template_comma if prompt.need_hyp_comma else hyp.template
                        for hyp_target, tfreq in zip(hyp_targets, hyp.freq_dist[num_h]):
                            if tfreq > 0:
                                hyp_data.append((template.format(
                                    target=make_indefinite(hyp_target) if hyp.need_article else hyp_target),
                                    tfreq))
                    for suffix, tfreq in hyp_data:
                        for noun, freq in zip(nouns, freqs):
                            if prompt.need_article:
                                noun_txt = make_indefinite(noun, suffix=suffix)
                            elif suffix is not None:
                                noun_txt = noun + suffix
                            else:
                                noun_txt = noun
                            text = prompt.template.format(noun=noun_txt)
                            total_freq = prompt.freq * tfreq * freq
                            if self.check_consistent:
                                for check_fsid in range(fsid, fsid + total_freq):
                                    d = self.get_sample_details(fsid=check_fsid)
                                    c_text, c_target = self.get_sample_text(details=d)
                                    if d[0] != usid or c_text != text or c_target != target:
                                        raise RuntimeError(
                                            f"Indexed-get mismatch for FSID {check_fsid}: "
                                            f"USID {usid} vs {d[0]}, '{text}' vs '{c_text}'")
                            yield UniqueSample(fsid=fsid, usid=usid, freq=total_freq,
                                               vocab=vocab, noun=noun_txt, text=text, target=target)
                            fsid += total_freq
                            usid += 1
        if self.check_consistent and (fsid != self.num_fsids or usid != self.num_usids):
            raise RuntimeError("Dataset generator did not generate the correct number of samples")

    # -- dataset interface ---------------------------------------------------------

    def loaded(self):
        if self.translation is not None and self.translation != self.target_config:
            raise RuntimeError("Target configuration translation is not available for the noun dataset")
        if self.use_cache:
            return self.cached()
        return self.embedder.inference_model()

    def configure_target(self):
        self.target_config = self.embedder.target_config

    def __getitem__(self, index):
        if self.use_cache:
            assert self.cache is not None, "Noun cache must be entered (loaded()) first"
            return self.cache.get_sample(self.get_sample_usid(index))
        text, target_noun = self.get_sample_text(fsid=index)
        return text, target_noun if self.use_targets else None, None, None

    # -- noun cache (ref noun_dataset.py:663-909) ------------------------------------

    def cache_config_key(self) -> str:
        """MD5 of the full generating configuration (ref noun_dataset.py:663-676)."""
        cfg = {
            "vocab_path": self.vocab_path,
            "num_tids": self.num_tids,
            "num_usids": self.num_usids,
            "vocab_thres": self.vocab_thres,
            "prompt_collection": self.prompt_collection,
            "hypernym_collection": self.hypernym_collection,
            "singular_prompts": [dataclasses.astuple(p) for p in self.singular_prompts],
            "plural_prompts": [dataclasses.astuple(p) for p in self.plural_prompts],
            "embedder_hash": self.embedder.get_configuration_hash(True, True, hexdigest=True),
        }
        return hashlib.md5(json.dumps(cfg, sort_keys=True, default=str).encode()).hexdigest()

    def cache_path(self) -> str:
        return os.path.join(self.cache_dir, f"noun_cache_{self.cache_config_key()}.bin")

    def cached(self):
        from contextlib import contextmanager

        @contextmanager
        def ctx():
            self.ensure_cache()
            self.cache = NounCache(self.cache_path(), self)
            with self.cache:
                yield self
            self.cache = None

        return ctx()

    def ensure_cache(self, sanity_samples: int = 32):
        os.makedirs(self.cache_dir, exist_ok=True)
        path = self.cache_path()
        if self.recache and os.path.exists(path):
            os.remove(path)
            self.recache = False
        if not os.path.exists(path):
            self._generate_cache(path)
        self._sanity_check_cache(path, sanity_samples)

    def _generate_cache(self, path: str, batch_size: int = 256):
        """Stream unique samples through the embedder (ref noun_dataset.py:855-909)."""
        tc = self.embedder.target_config
        assert tc is not None, "Embedder target config required to generate the noun cache"
        F = self.embedder.embed_dim
        C = tc.token_length
        row_bytes = F * 4 + C * 4 + C
        log.info(f"Generating noun cache ({self.num_usids} USIDs, "
                 f"{self.num_usids * row_bytes / (1 << 20):.1f}MiB): {path}")
        tmp = path + ".tmp"
        with self.embedder.inference_model(), open(tmp, "wb") as f:
            buf_texts, buf_targets = [], []

            def flush():
                if not buf_texts:
                    return
                embeds = self.embedder.inference_text(buf_texts)
                ids, mask = self.embedder.tokenize_target(buf_targets, max_tokens=C + 1)
                ids_fixed = np.full((len(buf_targets), C), tc.pad_token_id, np.int32)
                mask_fixed = np.ones((len(buf_targets), C), bool)
                ids_fixed[:, :ids.shape[1]] = ids
                if mask is not None:
                    mask_fixed[:, :mask.shape[1]] = mask
                for e, t, m in zip(embeds, ids_fixed, mask_fixed):
                    f.write(e.astype(np.float32).tobytes())
                    f.write(t.astype(np.int32).tobytes())
                    f.write(m.astype(np.bool_).tobytes())
                buf_texts.clear()
                buf_targets.clear()

            for sample in self.unique_sample():
                buf_texts.append(sample.text)
                buf_targets.append(sample.target)
                if len(buf_texts) >= batch_size:
                    flush()
            flush()
        os.replace(tmp, path)
        log.info("Finished generating noun cache")

    def _sanity_check_cache(self, path: str, sanity_samples: int):
        """Re-embed random USIDs and compare (ref noun_dataset.py:757-849)."""
        tc = self.embedder.target_config
        F, C = self.embedder.embed_dim, tc.token_length
        row_bytes = F * 4 + C * 4 + C
        size = os.path.getsize(path)
        if size != self.num_usids * row_bytes:
            raise RuntimeError(f"Noun cache has wrong size: {size} vs {self.num_usids * row_bytes}")
        rng = random.Random(0)
        usids = sorted(rng.sample(range(self.num_usids), min(sanity_samples, self.num_usids)))
        cache = NounCache(path, self)
        with cache, self.embedder.inference_model():
            for usid in usids:
                embed, target, mask, _ = cache.get_sample(usid)
                text, target_noun = self.get_sample_text(usid=usid)
                ref_embed = self.embedder.inference_text([text])[0]
                if not np.allclose(embed, ref_embed, atol=1e-4, rtol=1e-3):
                    raise RuntimeError(f"Noun cache embedding mismatch at USID {usid} ('{text}')")
                ids, _ = self.embedder.tokenize_target(target_noun)
                if not np.array_equal(target[: ids.shape[1]], ids[0]):
                    raise RuntimeError(f"Noun cache target mismatch at USID {usid}")

    # -- loader ---------------------------------------------------------------------

    def create_loader(self, batch_size: int, training: bool, *, num_threads: int = 1,
                      prefetch: int = 2, device=None, seed: Optional[int] = None):
        """(NounLoader, LoaderInfo). Batches are numpy arrays (the training loop
        copies them to its device); `device` only marks LoaderInfo.on_device."""
        loader = NounLoader(self, batch_size=batch_size, training=training, seed=seed,
                            prefetch=prefetch)
        complete, last = divmod(self.num_fsids, batch_size)
        if training and last:
            last = 0
        info = LoaderInfo(num_workers=num_threads, prefetch_factor=prefetch, pin_memory=False,
                          on_device=device is not None, batch_size=batch_size, batch_size_last=last,
                          complete_batches=complete, incomplete_batch=bool(last),
                          epoch_batches=complete + bool(last),
                          epoch_samples=complete * batch_size + last,
                          available_samples=self.num_fsids)
        return loader, info


class NounCache:
    """Memory-mapped [embed|target|mask] rows per USID."""

    def __init__(self, path: str, dataset: NounDataset):
        self.path = path
        self.dataset = dataset
        tc = dataset.embedder.target_config
        self.F = dataset.embedder.embed_dim
        self.C = tc.token_length
        self.row_bytes = self.F * 4 + self.C * 4 + self.C
        self._mm: Optional[np.memmap] = None

    def __enter__(self):
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self

    def __exit__(self, *exc):
        self._mm = None
        return False

    def get_sample(self, usid: int):
        row = self._mm[usid * self.row_bytes:(usid + 1) * self.row_bytes]
        embed = np.frombuffer(row[: self.F * 4], dtype=np.float32)
        target = np.frombuffer(row[self.F * 4: self.F * 4 + self.C * 4], dtype=np.int32)
        mask = np.frombuffer(row[self.F * 4 + self.C * 4:], dtype=np.bool_)
        return embed, target, mask, None

    def get_samples(self, usids: np.ndarray):
        embeds = np.empty((len(usids), self.F), np.float32)
        targets = np.empty((len(usids), self.C), np.int32)
        masks = np.empty((len(usids), self.C), np.bool_)
        for i, u in enumerate(usids):
            e, t, m, _ = self.get_sample(int(u))
            embeds[i], targets[i], masks[i] = e, t, m
        return embeds, targets, masks


class NounLoader:
    """Shuffled FSID loader with on-the-fly embedding (uncached) or cache reads
    (ref noun_dataset.py:505-629)."""

    def __init__(self, dataset: NounDataset, batch_size: int, training: bool,
                 seed: Optional[int] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.training = training
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = self.dataset.num_fsids
        return n // self.batch_size if self.training else -(-n // self.batch_size)

    def __iter__(self):
        n = self.dataset.num_fsids
        order = self.rng.permutation(n) if self.training else np.arange(n)
        num_batches = len(self)
        ds = self.dataset
        tc = ds.embedder.target_config
        for b in range(num_batches):
            fsids = order[b * self.batch_size:(b + 1) * self.batch_size]
            if ds.use_cache:
                usids = np.asarray([ds.get_sample_usid(int(f)) for f in fsids])
                embeds, targets, masks = ds.cache.get_samples(usids)
            else:
                texts, target_nouns = zip(*(ds.get_sample_text(fsid=int(f)) for f in fsids))
                embeds = ds.embedder.inference_text(list(texts))
                targets = masks = None
                if ds.use_targets:
                    ids, mask = ds.embedder.tokenize_target(list(target_nouns))
                    targets, masks = ids, mask
            if targets is not None and tc is not None and not tc.fixed_token_length:
                all_masked = masks.all(axis=0)
                if all_masked.any():
                    cut = int(np.argmax(all_masked))
                    if cut > 0:
                        targets, masks = targets[:, :cut], masks[:, :cut]
            yield embeds, targets, masks, None
