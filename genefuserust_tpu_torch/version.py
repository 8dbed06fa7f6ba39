"""Version constants.

The report version string mirrors the reference binary's
(reference: src/core/html_reporter.rs:11 `FUSIONSCAN_VER` = Cargo package
version, Cargo.toml:3 -> "0.1.2") so reports compare equal field-by-field.
"""

# Version printed in HTML/JSON reports and the final timing line.
GENEFUSE_VER = "0.1.2"

# Our own engine version, reported via `--version`.
ENGINE_VER = "0.1.0"
