"""The service's padding over the window: CaptionService.stats()'s
padded_rows over the rows it decoded (real and padded), both as the window
moved them."""


def read(rec):
    return None if rec is None else rec.extra.get("serve_pad_pct")
