"""H x W x the frames completed in the window, over the time from the
window's start to the last frame's image on the host (host clock)."""


def read(record):
    if record["unit"] != "frame" or not record["window"]["frames"]:
        return None
    return record["window"]["rays"] / record["window"]["seconds"]
