"""Device-idle time while the entry point waits for its input: the next batch in `Trainer.fit` (`caduceus.train.next_batch`), a variant's window read and tokenized in `dump_embeddings` (`caduceus.vep.read`); ms per unit of work."""

from benchmark.metrics._spans import INPUT_SPANS, idle_ms_under


def read(view):
    return idle_ms_under(view, INPUT_SPANS)
