"""Host utilities: config, hashing, memory planning, logging."""
