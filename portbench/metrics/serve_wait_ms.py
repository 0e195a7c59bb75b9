"""The service's mean wait of a request in its queue before its batch
decoded, over the window's requests (CaptionService.stats()'s wait sum and
request count, as the window moved them)."""


def read(rec):
    return None if rec is None else rec.extra.get("serve_wait_ms")
