"""Host milliseconds of the chunk loop per 1,000 gestures in the traced
jobs: the program's ``sample.chunk`` spans
(``wordgesture_gan_tpu_torch.utils.profiling``; the host's noise key and
the launches of each chunk), over ``sample.call``'s items. It sets the pace
while the card idles. None without the spans: an untraced run, or a
program that has none."""


def read(ctx):
    try:
        from wordgesture_gan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    spans = span_totals()
    gestures = spans.get("sample.call", {}).get("items")
    if not gestures or "sample.chunk" not in spans:
        return None
    return spans["sample.chunk"]["seconds"] * 1e3 / (gestures / 1e3)
