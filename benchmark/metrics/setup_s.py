"""setup_s: seconds from the process's start to the window's (imports,
weights made on the card, kernels built or loaded, the cell's shapes
warmed up), by the host's clock."""


def read(ctx, record):
    return record["setup_s"]
