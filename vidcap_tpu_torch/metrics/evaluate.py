"""Offline caption evaluation (SURVEY.md C16, §3.4): BLEU-1..4, ROUGE-L, CIDEr-D,
METEOR over a {video_id: [caption]} results json — the coco-caption toolkit's role,
without the JVM dependency (pure-Python PTB-style tokenizer, vocab.py).

A copy of ``vidcap_tpu/metrics/evaluate.py`` so the PyTorch package imports
nothing of the JAX one; tests/test_torch_metrics.py holds the two equal."""
from __future__ import annotations

from typing import Dict, List

from vidcap_tpu_torch.data.vocab import ptb_tokenize
from vidcap_tpu_torch.metrics.bleu import corpus_bleu
from vidcap_tpu_torch.metrics.cider import cider_d
from vidcap_tpu_torch.metrics.meteor import meteor
from vidcap_tpu_torch.metrics.rouge import rouge_l


def evaluate_captions(gts: Dict[str, List[str]], res: Dict[str, List[str]]
                      ) -> Dict[str, float]:
    """gts: {vid: [ref strings]}; res: {vid: [candidate string]} (first used).

    Videos whose reference list is EMPTY are excluded from scoring — they are
    alignment placeholders on partially-captioned corpora (MSR-VTT
    test-server rows, data/scale_small), not documents; an empty list would
    otherwise crash bleu's min() over reference lengths. Mirrors
    the IDF document-count rule in metrics/cider.py / objectives/reward_tables.py.
    """
    gts_tok = {v: [ptb_tokenize(c) for c in caps]
               for v, caps in gts.items() if caps}
    res_tok = {v: ptb_tokenize(caps[0]) for v, caps in res.items()
               if v in gts_tok}
    if not res_tok:
        raise ValueError("no scorable (candidate, non-empty-references) "
                         "pairs — every candidate video lacks references")
    bleu = corpus_bleu(gts_tok, res_tok)
    rouge, _ = rouge_l(gts_tok, res_tok)
    cider, _ = cider_d(gts_tok, res_tok)
    met, _ = meteor(gts_tok, res_tok)
    return {
        "Bleu_1": bleu[0], "Bleu_2": bleu[1], "Bleu_3": bleu[2],
        "Bleu_4": bleu[3], "ROUGE_L": rouge, "CIDEr": cider, "METEOR": met,
    }
