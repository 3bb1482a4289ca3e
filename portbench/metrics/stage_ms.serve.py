"""Host ms a request inside StreamingEngine.submit (staging into pinned
memory and the copies' enqueue, the forward's launches), from the
harness's own host clock around each submit of the traced requests."""


def read(view):
    spans = view.spans.get('submit')
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
