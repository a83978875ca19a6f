"""Host seconds a sample spent blocked on the card: the program's
sync.put and sync.fetch spans (every upload, read, item and masked
selection that synchronises with the card) under each sample span of the
traced window (one step), over those samples."""
import program_spans


def read(run):
    return program_spans.per_sample_seconds(
        run, lambda name: name.startswith("sync."))
