"""Host-side utilities: env-var configuration and the device."""
