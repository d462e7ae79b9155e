"""What every cell shares: finding specs by name, the measured window, the
captures and the comparison that decide ``correct``, the traced run's
spans and the launcher of multi-card cells."""
