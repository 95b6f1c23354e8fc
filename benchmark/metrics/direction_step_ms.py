"""direction_step_ms: the window's wall time over the prompt-steps it
completed (a step of P prompts counts P), whole jobs with their precompute
back to back, by the host's clock."""


def read(ctx, record):
    if "prompt_steps" not in record or not record["prompt_steps"]:
        return None
    return 1e3 * record["window_s"] / record["prompt_steps"]
