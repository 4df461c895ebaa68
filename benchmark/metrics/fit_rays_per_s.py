"""H x W x the steps of the jobs completed in the window, over the time
from the window's start to the end of the last completed job (host
clock)."""


def read(record):
    if record["unit"] != "step" or not record["window"]["steps"]:
        return None
    return record["window"]["rays"] / record["window"]["seconds"]
