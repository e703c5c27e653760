"""Networks of the port: MViT, VGGish, AudioAttnNet, SalUNet and their
composition, with the reference's torch parameter names."""
