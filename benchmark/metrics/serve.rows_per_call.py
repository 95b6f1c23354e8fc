"""serve.rows_per_call: images completed over the coalescing dispatcher's
batched calls in the window (its `batched_calls` counter, read through
EditService.stats())."""


def read(ctx, record):
    if not record.get("batched_calls"):
        return None
    return record["images"] / record["batched_calls"]
