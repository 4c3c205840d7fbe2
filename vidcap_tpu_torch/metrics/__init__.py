from vidcap_tpu_torch.metrics.cider import CiderScorer, cider_d  # noqa: F401
from vidcap_tpu_torch.metrics.bleu import corpus_bleu, sentence_bleu4  # noqa: F401
from vidcap_tpu_torch.metrics.rouge import rouge_l  # noqa: F401
from vidcap_tpu_torch.metrics.evaluate import evaluate_captions  # noqa: F401
