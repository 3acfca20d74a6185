"""Host milliseconds of a sampling call's staging per 1,000 gestures in the
traced jobs: the program's spans ``sample.pad``, ``sample.copy_in`` and
``sample.copy_out`` (``wordgesture_gan_tpu_torch.utils.profiling``), over
``sample.call``'s items. The card has nothing queued meanwhile. None without
the spans: an untraced run, or a program that has none."""

STAGES = ("sample.pad", "sample.copy_in", "sample.copy_out")


def read(ctx):
    try:
        from wordgesture_gan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    spans = span_totals()
    gestures = spans.get("sample.call", {}).get("items")
    if not gestures:
        return None
    return sum(spans[n]["seconds"] for n in STAGES if n in spans) * 1e3 / (gestures / 1e3)
