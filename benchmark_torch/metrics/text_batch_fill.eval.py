"""``text_batch_fill.eval``: real prompt rows over the rows of the fixed
batches they were padded to, over every ``encode_texts_tokens`` call of the
window (counted by the harness's wrapper on the encoder it built)."""


def read(run):
    fill = run.window.get("text_fill")
    return None if not fill else 100.0 * fill
