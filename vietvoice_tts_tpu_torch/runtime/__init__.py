"""Runtime: weight store, pack codec, engine core."""
