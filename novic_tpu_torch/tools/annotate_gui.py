"""Human annotation GUI (offline tooling, parity with reference
dataset_annotation.py): shows each (image, predicted noun) pair in an OpenCV
window; keyboard categories q/w/o/p/i (correct_primary / correct_secondary /
close_primary / close_secondary / incorrect), u = undo, s = skip, ESC = save
and exit. Writes the annotation JSON schema {sample: {category: [nouns]}}.

Gated on cv2 + a display; the annotation bookkeeping (apply_key, undo,
serialization) is pure and testable headlessly.

The port's copy of novic_tpu.tools.annotate_gui, with the same
functions and names. It runs no kernel and touches no device.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from novic_tpu_torch.utils.logger import log

KEY_CATEGORY = {"q": "correct_primary", "w": "correct_secondary",
                "o": "close_primary", "p": "close_secondary", "i": "incorrect"}


class AnnotationSession:
    """Pure annotation state machine over (image_path, noun) pairs."""

    def __init__(self, pairs: Sequence[tuple[str, str]],
                 annotations: Optional[dict] = None):
        self.pairs = list(pairs)
        self.annotations: dict[str, dict[str, list[str]]] = annotations or {}
        self.index = 0
        self.history: list[tuple[int, str, str, str]] = []
        # Skip already-annotated pairs on resume
        while self.index < len(self.pairs) and self._already_annotated(*self.pairs[self.index]):
            self.index += 1

    def _already_annotated(self, image_path: str, noun: str) -> bool:
        sample = os.path.basename(image_path)
        return any(noun in nouns for nouns in self.annotations.get(sample, {}).values())

    @property
    def current(self) -> Optional[tuple[str, str]]:
        return self.pairs[self.index] if self.index < len(self.pairs) else None

    @property
    def done(self) -> bool:
        return self.index >= len(self.pairs)

    def apply_key(self, key: str) -> bool:
        """Returns True if the key advanced/changed state."""
        if key == "u":
            return self.undo()
        if key == "s":
            if not self.done:
                self.index += 1
                return True
            return False
        category = KEY_CATEGORY.get(key)
        if category is None or self.done:
            return False
        image_path, noun = self.pairs[self.index]
        sample = os.path.basename(image_path)
        self.annotations.setdefault(sample, {}).setdefault(category, []).append(noun)
        self.history.append((self.index, sample, category, noun))
        self.index += 1
        return True

    def undo(self) -> bool:
        if not self.history:
            return False
        index, sample, category, noun = self.history.pop()
        nouns = self.annotations[sample][category]
        nouns.remove(noun)
        if not nouns:
            del self.annotations[sample][category]
        if not self.annotations[sample]:
            del self.annotations[sample]
        self.index = index
        return True

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.annotations, f, indent=2, sort_keys=True)
        os.replace(tmp, path)


def run_gui(predictions_path: str, annotations_path: str):
    """Interactive loop (requires cv2 and a display)."""
    import cv2

    with open(predictions_path) as f:
        preds = json.load(f)
    pairs = []
    for model_out in preds["models"].values():
        for gout in model_out["gencfgs"].values():
            for key, top in zip(preds["keys"], gout["pred"]):
                pairs.append((key, top[0]))
    annotations = {}
    if os.path.exists(annotations_path):
        with open(annotations_path) as f:
            annotations = json.load(f)
    session = AnnotationSession(pairs, annotations)

    log.info("Keys: q=correct_primary w=correct_secondary o=close_primary "
             "p=close_secondary i=incorrect u=undo s=skip ESC=save+exit")
    while not session.done:
        image_path, noun = session.current
        img = cv2.imread(image_path)
        if img is None:
            log.warning(f"Could not read image: {image_path}")
            session.apply_key("s")
            continue
        display = img.copy()
        cv2.putText(display, f"{noun}  [{session.index + 1}/{len(session.pairs)}]",
                    (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.9, (0, 255, 0), 2)
        cv2.imshow("novic_tpu annotation", display)
        key = cv2.waitKey(0) & 0xFF
        if key == 27:  # ESC
            break
        session.apply_key(chr(key) if 32 <= key < 127 else "")
        session.save(annotations_path)
    session.save(annotations_path)
    cv2.destroyAllWindows()
    log.info(f"Annotations saved: {annotations_path}")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Human annotation GUI for predictions")
    p.add_argument("--predictions", required=True)
    p.add_argument("--annotations", required=True)
    a = p.parse_args()
    run_gui(a.predictions, a.annotations)
