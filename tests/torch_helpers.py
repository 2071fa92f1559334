"""Shared helpers of the port's tests: the port's config held to the JAX
package's."""

import dataclasses


def assert_config_equals_jax(ours, theirs) -> None:
    """``ours`` (a config dataclass of ``avsum_torch``) equals ``theirs``
    (the JAX package's) on every key the JAX package has; the keys only
    the port has (the decoder encoder's, ``models/decoder.py``) hold
    their defaults."""
    def walk(mine, want, default, path):
        assert set(want) <= set(mine), path
        for key, value in mine.items():
            if isinstance(value, dict):
                walk(value, want[key], default[key], f"{path}{key}.")
            elif key in want:
                assert value == want[key], f"{path}{key}"
            else:
                assert value == default[key], f"{path}{key}: not its default"

    walk(dataclasses.asdict(ours), dataclasses.asdict(theirs),
         dataclasses.asdict(type(ours)()), "")
