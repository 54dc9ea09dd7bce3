"""Engine: optimizer, schedule and train step."""
