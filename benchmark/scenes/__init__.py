"""Scene kinds: each module turns a configuration's `scene` entry into the
raw inputs both sides take, a structure (plain dict) and float32 numpy
arrays by parameter field. The harness finds a kind by its name
(`benchmark/scenes/<kind>.py`) and calls its `build(scene_entry)`."""
