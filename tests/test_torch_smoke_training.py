"""``chip_smoke.py``'s phase ``detection_losses`` rehearsed on the CPU with
ViTDet-B's backbone cut to 2 blocks of 96 (the pyramid, the RPN and the ROI
heads at their width, the frame at 672): both sides run on the CPU, so the
card-against-CPU comparison must find the losses and gradients equal, and
the phase reports its counts."""

import json

import chip_smoke


def test_detection_losses_phase_on_the_cpu(monkeypatch, capsys):
    config = chip_smoke.vitdet_config

    def slim(eventful, size, *args, **kwargs):
        out = config(eventful, size, *args, depth=2, window_indices=(0,), **kwargs)
        out["backbone_config"]["block_config"].update(dim=96, heads=12)
        return out

    monkeypatch.setattr(chip_smoke, "vitdet_config", slim)
    monkeypatch.setattr(chip_smoke.torch.cuda, "empty_cache", lambda: None)
    chip_smoke.detection_losses(chip_smoke.torch.device("cpu"), "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "detection_losses" and line["same_samples"]
    assert line["anchors"] == 3 * (168 ** 2 + 84 ** 2 + 42 ** 2 + 21 ** 2 + 11 ** 2)
    assert line["proposals"] == 1000 and 0 < line["valid_proposals"] <= 1000
    assert 0 < line["foreground_rois"] <= line["sampled_rois"] <= 128
    assert set(line["losses_card"]) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                                        "loss_box_reg"}
    assert all(v == 0 for v in line["loss_rel_err"].values())
    assert all(v == 0 for v in line["grad_rel_err"].values())
