"""Host milliseconds of an epoch boundary in the traced epochs: the
program's spans ``epoch.shuffle``, ``epoch.keys``, ``epoch.record`` and
``epoch.checkpoint`` (``wordgesture_gan_tpu_torch.utils.profiling``), summed
and divided by the count of ``epoch.steps``. That is the time from one
epoch's loss copy, which drains the card, to the next epoch's first replay;
``epoch.callback`` is the caller's code (here the benchmark's) and is left
out. None without the spans: an untraced run, or a program that has none."""

BOUNDARY = ("epoch.shuffle", "epoch.keys", "epoch.record", "epoch.checkpoint")


def read(ctx):
    try:
        from wordgesture_gan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    spans = span_totals()
    epochs = spans.get("epoch.steps", {}).get("count")
    if not epochs:
        return None
    return sum(spans[n]["seconds"] for n in BOUNDARY if n in spans) * 1e3 / epochs
