"""Multi-device scheduling over a (dp, tp) mesh of torch devices."""
