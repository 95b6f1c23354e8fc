"""edit_images_per_s: photos edited (inverted, edited and rendered) over
the window's wall time, by the host's clock."""


def read(ctx, record):
    if not record.get("images"):
        return None
    return record["images"] / record["window_s"]
