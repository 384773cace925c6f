"""Share of the traced window in which nothing ran on the card (no kernel,
copy or fill), in %: 100 x (1 - busy / window), from the device trace."""


def read(record):
    s = record["trace"]
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
