"""Host seconds of the driver's per-sample set-up a sample: the
program's spans dada.backend_init (the sample's compare backend: its
uniques packed, uploaded and tabled on the card) and dada.setup (the
engine's construction) under each sample span of the traced window (one
step), over those samples."""
import program_spans


def read(run):
    return program_spans.per_sample_seconds(
        run, lambda name: name in ("dada.backend_init", "dada.setup"))
