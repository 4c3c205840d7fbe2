"""Captioner: the host time of the program's ``captioner.upload`` spans
(the features and mask to the card, ``Captioner.decode_local``) in the
traced slice, over its ``captioner.decode`` spans, in ms a decode."""
from benchmark import inside


def read(r):
    spans = inside.program_spans(r)
    return inside.upload_ms(spans) if spans else None
